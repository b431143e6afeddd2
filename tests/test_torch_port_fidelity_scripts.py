"""The port's fidelity gate (``scripts/fidelity_gate_torch.py``), its plain
path (``dsml_thesis_tpu_torch/tools/plain.py``) and head-width convergence
script (``scripts/dh_convergence_torch.py``) against the JAX package's
scripts, on the CPU.

* ``fidelity_gate_torch.py --tiny --cpu`` (with ``--isolate-flash --csim
  --ab-env``) prints one JSON line holding every key the JAX gate writes,
  with finite values; the reference run launches nothing; ``--ckpt``
  puts a state_dict's weights in both runs' models.
* ``chip_smoke.py``'s fidelity phase: the flagship run's launches counted
  from the headline YAML's blocks (meta device).
* ``dh_convergence_torch.py``: ``model_cfg`` equals the JAX script's; the
  JAX model's initial parameters load into the port's model with
  ``from_jax_params`` (the same shapes), and the zero initialisation puts
  zeros where the JAX init does; the 16 batches and the validation batch
  equal the JAX script's arrays in bits; a 3-step ``--cpu`` run prints a
  record a width with the JAX script's keys (and its compute type), and
  the summary lines; under ``--dtype bfloat16`` the model computes in bf16.
"""
import importlib.util
import io
import json
import os
import re
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from dsml_thesis_tpu.config import build_model as jax_build_model
from dsml_thesis_tpu_torch.config import build_model, load_config
from dsml_thesis_tpu_torch.convert import from_jax_params
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_gate_keys():
    """Every key the JAX gate puts in its JSON line (from its source)."""
    src = open(os.path.join(ROOT, "scripts", "fidelity_gate.py")).read()
    first = re.search(r"result = \{(.*?)\}", src, re.S).group(1)
    keys = set(re.findall(r'"(\w+)":', first))
    keys |= set(re.findall(r'result\["(\w+)"\] =', src))
    assert {"metric", "value", "csim_delta", "ab_env"} <= keys
    return keys


def _gate(argv):
    out = io.StringIO()
    with redirect_stdout(out):
        result = _script("fidelity_gate_torch").main(argv)
    assert json.loads(out.getvalue().splitlines()[-1]) == result
    return result


def test_gate_tiny_emits_the_jax_gates_keys():
    result = _gate(["--tiny", "--cpu", "--isolate-flash", "--csim",
                    "--ab-env", "DSML_GELU_EXACT=1"])
    assert _jax_gate_keys() <= set(result)
    for k in ("value", "psnr_flash_only_db", "psnr_bf16_given_flash_db",
              "csim_flag_vs_ref", "csim_delta"):
        assert np.isfinite(result[k]), k
    assert result["metric"] == "psnr_bf16flash_vs_fp32_db"
    assert (result["steps"], result["frames"], result["res"]) == (4, 2, 16)
    assert result["ab_env"] == "DSML_GELU_EXACT=1"
    assert result["csim_backbone"] == "random-init iresnet18"
    assert set(result["seconds"]) == {"reference", "flagship", "flash_only"}
    # on the CPU every wrapper runs its plain version: nothing launches
    assert not any(result["launches"].values())
    assert "DSML_GELU_EXACT" not in os.environ


def test_gate_reads_the_weights_of_ckpt(tmp_path):
    """``--ckpt`` goes through ``utils_io.load_params``: the gate's model
    holds the file's weights (a state_dict of another seed, its codebook
    spread out), not the seed's; the bf16 twin holds the same weights."""
    fidelity = _script("fidelity_gate_torch")
    cfg = yaml.safe_load(fidelity.TINY_MEAD_CFG)
    torch.manual_seed(5)
    ldm = build_model(cfg["model"])
    torch.nn.init.normal_(ldm.first_stage.quantize.embedding.weight)
    path = str(tmp_path / "weights.pt")
    torch.save(ldm.state_dict(), path)
    args = type("A", (), dict(seed=0, ckpt=path))()
    got, note = fidelity.build(cfg, "float32", args, torch.device("cpu"))
    assert note is None     # a spread codebook is kept as it is
    for k, v in ldm.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    twin, _ = fidelity.build(cfg, "bfloat16", args, torch.device("cpu"),
                             weights=got.state_dict())
    assert twin.unet.dtype == torch.bfloat16
    for k, v in got.state_dict().items():
        assert torch.equal(twin.state_dict()[k], v), k
    args.ckpt = None
    seeded, note = fidelity.build(cfg, "float32", args, torch.device("cpu"))
    assert note is not None
    assert not torch.equal(seeded.unet.conv_in.weight, got.unet.conv_in.weight)
    result = _gate(["--tiny", "--cpu", "--ckpt", path])
    assert result["ckpt"] == path and "codebook" not in result


def test_plain_path_puts_the_plain_versions_in_place(monkeypatch):
    from dsml_thesis_tpu_torch.models import autoencoder, unet
    from dsml_thesis_tpu_torch.ops import attention as A
    from dsml_thesis_tpu_torch.ops import conv_gn as C
    from dsml_thesis_tpu_torch.tools.plain import plain_path

    monkeypatch.setenv("DSML_PALLAS_GN", "1")
    monkeypatch.setenv("DSML_FLASH_STREAMING", "1")
    kernels = (unet.flash_attention_fproj, unet.packed_multi_head_attention,
               unet.multi_head_attention, autoencoder.multi_head_attention,
               unet.conv_stats)
    with plain_path({"DSML_FLASH_STREAMING": "1",
                     "DSML_PALLAS_GN": "1"}):
        assert unet.flash_attention_fproj is A.fproj_reference
        assert unet.packed_multi_head_attention is A.packed_reference
        assert unet.multi_head_attention is A.streaming_attention_reference
        assert autoencoder.multi_head_attention is \
            A.streaming_attention_reference
        assert unet.conv_stats is C.conv_stats_reference
        assert "DSML_PALLAS_GN" not in os.environ
        assert os.environ["DSML_FLASH_STREAMING"] == "1"
    with plain_path({}):
        assert unet.multi_head_attention is A.attention_reference
        assert "DSML_FLASH_STREAMING" not in os.environ
    assert (unet.flash_attention_fproj, unet.packed_multi_head_attention,
            unet.multi_head_attention, autoencoder.multi_head_attention,
            unet.conv_stats) == kernels
    assert os.environ["DSML_PALLAS_GN"] == "1"


def test_smoke_counts_of_the_fidelity_phase():
    """The flagship run of the headline config at DDIM-10, F = 2: row 1
    once a self-attention a UNet call (11 short ones, 20 calls), row 2 in
    the first stage's attention blocks (2 encodes x 3, 2 decodes x 4)."""
    cfg = load_config([chip_smoke.CONFIG])
    with torch.device("meta"):
        ldm = build_model(cfg["model"])
    got = chip_smoke.fidelity_launches(ldm, chip_smoke.FIDELITY_FRAMES,
                                       chip_smoke.FIDELITY_DDIM_STEPS)
    assert chip_smoke.count_attentions(ldm.unet, ldm.image_size) == (11, 0)
    assert {k: v for k, v in got.items() if v} == {
        "flash_attention_fproj": 220, "flash_attention": 14}


# --------------------------------------------------------------------------
# dh_convergence
# --------------------------------------------------------------------------

RES, BATCH = 16, 2


@pytest.fixture(scope="module")
def scripts():
    return _script("dh_convergence"), _script("dh_convergence_torch")


def test_model_cfg_and_shapes_match_the_jax_script(scripts):
    jscript, tscript = scripts
    for dh in (32, 64):
        assert tscript.model_cfg(dh, 64) == jscript.model_cfg(dh, 64)
    cfg = tscript.model_cfg(32, RES)
    batch = tscript.make_batches(cfg, BATCH, RES)[1]
    jldm = jax_build_model(cfg)
    params = jax.jit(jldm.init_params)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    tldm = build_model(cfg)
    sd = from_jax_params(jax.tree.map(np.asarray, params))
    tldm.load_state_dict(sd, strict=True)     # every shape the JAX model's
    fresh = build_model(cfg)
    tscript.zero_block_outputs(fresh.unet)
    own = fresh.state_dict()
    zeros_jax = {k for k, v in sd.items()
                 if k.startswith("unet.") and not v.any()}
    zeros_port = {k for k, v in own.items()
                  if k.startswith("unet.") and not v.any()}
    # the JAX init's zeros, and the biases the port's default init leaves
    # zero elsewhere (the norms')
    conv = lambda keys: {k for k in keys if k.endswith(".weight")
                         and own[k].dim() == 4}
    assert conv(zeros_jax) == conv(zeros_port) and len(conv(zeros_port)) > 5


def test_batches_equal_the_jax_scripts(scripts, monkeypatch):
    """The JAX script's arrays, caught where it hands them to ``jnp``
    (the run is stopped before its model's init), against the port's."""
    jscript, tscript = scripts
    seen = []

    class Recorder:
        @staticmethod
        def asarray(a):
            seen.append(np.array(a))
            return a

    class Stop(Exception):
        pass

    class NoRandom:
        class random:
            @staticmethod
            def PRNGKey(seed):
                raise Stop

    monkeypatch.setattr(jscript, "jnp", Recorder)
    monkeypatch.setattr(jscript, "jax", NoRandom)
    args = type("A", (), dict(res=RES, batch=BATCH, seed=0))()
    with pytest.raises(Stop):
        jscript.run_width(32, args)
    batches, val = tscript.make_batches(tscript.model_cfg(32, RES), BATCH,
                                        RES)
    keys = ("image", "masked_image", "identity", "class_label", "audio")
    ours = [b[k] for b in batches + [val] for k in keys]
    assert len(seen) == len(ours) == 17 * 5
    for a, b in zip(seen, ours):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_three_step_cpu_run_prints_its_records(scripts, tmp_path):
    _, tscript = scripts
    out = io.StringIO()
    path = str(tmp_path / "curves.json")
    with redirect_stdout(out):
        recs = tscript.main(["--cpu", "--steps", "3", "--res", str(RES),
                             "--batch", str(BATCH), "--val-every", "2",
                             "--out", path])
    lines = out.getvalue().splitlines()
    printed = [json.loads(line) for line in lines[:2]]
    assert printed == json.loads(json.dumps(recs)) == json.load(open(path))
    keys = {"dh", "params_M", "steps", "lr", "batch", "res", "loss_first10",
            "loss_last10pct", "val", "train_s", "losses_every5", "dtype"}
    for r, dh in zip(printed, (32, 64)):
        assert set(r) == keys and r["dh"] == dh and r["steps"] == 3
        assert np.isfinite(r["loss_first10"]) and len(r["val"]) == 2
        assert len(r["losses_every5"]) == 1
    assert lines[2].startswith("# dh32: ") and "| dh64: " in lines[2]
    assert lines[3].startswith("# curve separation: max ")


def test_dtype_option_sets_the_compute_type(scripts, monkeypatch):
    _, tscript = scripts
    built = []
    from dsml_thesis_tpu_torch import config

    real = config.build_model

    def spy(cfg):
        ldm = real(cfg)
        built.append(ldm)
        return ldm

    monkeypatch.setattr(config, "build_model", spy)
    out = io.StringIO()
    with redirect_stdout(out):
        recs = tscript.main(["--cpu", "--steps", "1", "--res", str(RES),
                             "--batch", str(BATCH), "--widths", "64",
                             "--dtype", "bfloat16"])
    assert recs[0]["dtype"] == "bfloat16" and np.isfinite(
        recs[0]["loss_first10"])
    (ldm,) = built
    assert ldm.unet.dtype == torch.bfloat16
    assert ldm.first_stage.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in ldm.parameters())


def test_gate_runs_dry_run_on_the_cpu(tmp_path):
    """``tools/gate_runs.py --cpu`` on the tiny config (a data node added):
    the training line, then the gate on the trained and on random weights,
    each with the tanh and the erf GELU in the flagship run."""
    from dsml_thesis_tpu_torch.tools import gate_runs

    cfg = yaml.safe_load(_script("fidelity_gate_torch").TINY_MEAD_CFG)
    cfg["data"] = {"params": {"batch_size": 2, "num_workers": 1}}
    path = str(tmp_path / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    out = io.StringIO()
    with redirect_stdout(out):
        gate_runs.main(["--cpu", "--workdir", str(tmp_path / "work"),
                        "--config", path, "--train-steps", "2",
                        "--gate-steps", "2", "--frames", "1", "--batch", "1"])
    recs = [json.loads(line) for line in out.getvalue().splitlines()
            if line.startswith('{"phase"')]
    assert [r["phase"] for r in recs] == ["train"] + ["gate"] * 4
    assert recs[0]["steps"] == 2 and np.isfinite(recs[0]["loss_last10"])
    assert [(r["weights"], r["gelu"]) for r in recs[1:]] == [
        ("trained", "tanh"), ("trained", "erf"), ("random", "tanh"),
        ("random", "erf")]
    for r in recs[1:]:
        assert _jax_gate_keys() - {"ab_env"} <= set(r)
        assert np.isfinite(r["value"]) and np.isfinite(r["csim_delta"])
        assert (r["ckpt"] == "random-init") == (r["weights"] == "random")
        assert (r.get("ab_env") == "DSML_GELU_EXACT=1") == (r["gelu"] == "erf")
