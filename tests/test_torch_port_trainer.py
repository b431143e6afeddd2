"""The port's Trainer, data loader and training CLI on the CPU.

The Trainer runs the case of the JAX package's own trainer test
(``tests/test_trainer.py``): the tiny 2-cond MEAD model on
``SyntheticDataset``, the same config node for both packages. What is held:
``max_steps`` honoured in mid-epoch, ``metrics.jsonl`` with train and
raw / EMA validation records, the LR scaling rule, a checkpoint round trip
that restores parameters, AdamW moments and EMA shadows bit for bit, resume
at the saved step, the top-k bookkeeping, and that every unported option
raises. The data side is held against the JAX package's loader: same
examples, same shuffled batches (exact: both are numpy under one seed).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from dsml_thesis_tpu.data import DataLoader as JaxDataLoader
from dsml_thesis_tpu.data import SyntheticDataset as JaxSyntheticDataset
from dsml_thesis_tpu_torch.config import instantiate_from_config
from dsml_thesis_tpu_torch.data import DataLoader, SyntheticDataset, collate
from dsml_thesis_tpu_torch.training.checkpointing import save_topk
from dsml_thesis_tpu_torch.training.loggers import CsvBackend, build_logger
from dsml_thesis_tpu_torch.training.trainer import Trainer
from test_ldm import TINY_MEAD_CFG
from test_torch_port_hygiene import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = {
    "image": [[16, 16, 3], "float32"],
    "masked_image": [[16, 16, 3], "float32"],
    "identity": [[16, 16, 3], "float32"],
    "class_label": [[], "int32"],
    "audio": [[5, 32], "float32"],
}


def _config(batch=8, length=16, val_length=None):
    cfg = yaml.safe_load(TINY_MEAD_CFG)
    node = lambda n: {"target": "dsml_thesis_tpu.data.SyntheticDataset",
                      "params": {"spec": SPEC, "length": n}}
    cfg["data"] = {"params": {
        "batch_size": batch, "num_workers": 2, "train": node(length),
        "validation": node(val_length or length)}}
    cfg["model"]["base_learning_rate"] = 1e-5
    return cfg


def _records(logdir):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

def test_synthetic_dataset_matches_jax_package():
    spec = {k: (tuple(s), d) for k, (s, d) in SPEC.items()}
    ours, theirs = SyntheticDataset(spec, 8, seed=3), JaxSyntheticDataset(
        spec, 8, seed=3)
    assert len(ours) == len(theirs) == 8
    for i in (0, 5):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)],
                         ids=["train-loader", "eval-loader"])
def test_loader_batches_match_jax_package(shuffle, drop_last):
    spec = {"x": ((3,), "float32"), "y": ((), "int32")}
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last,
              num_workers=2, seed=7)
    ours = DataLoader(SyntheticDataset(spec, 10), **kw)
    theirs = JaxDataLoader(JaxSyntheticDataset(spec, 10), process_index=0,
                           process_count=1, **kw)
    assert len(ours) == len(theirs) == (2 if drop_last else 3)
    for epoch in range(2):          # a new permutation each epoch
        got, want = list(ours), list(theirs)
        assert len(got) == len(want) == len(ours)
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
    assert ours.epoch == 2


def test_collate_keeps_strings_as_lists():
    out = collate([{"a": np.zeros(2), "p": "x"}, {"a": np.ones(2), "p": "y"}])
    assert out["a"].shape == (2, 2) and out["p"] == ["x", "y"]


def test_loader_surfaces_a_dataset_error():
    class Broken(SyntheticDataset):
        def __getitem__(self, i):
            raise KeyError("broken example")

    with pytest.raises(KeyError):
        list(DataLoader(Broken({}, 4), batch_size=2))


def test_dataset_targets_and_unported_targets():
    for target in ("dsml_thesis_tpu.data.SyntheticDataset",
                   "dsml_thesis_tpu.data.datasets.SyntheticDataset",
                   "dsml_thesis_tpu_torch.data.SyntheticDataset"):
        ds = instantiate_from_config(
            {"target": target, "params": {"spec": SPEC, "length": 3}})
        assert isinstance(ds, SyntheticDataset) and len(ds) == 3
    # the MEAD datasets are ported (tests/test_torch_port_mead_data.py builds
    # them from files); a target still unported raises
    with pytest.raises(NotImplementedError):
        instantiate_from_config(
            {"target": "ldm.modules.encoders.modules.LandmarkEncoder",
             "params": {"output_dim": 128}})


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    logdir = str(tmp_path_factory.mktemp("run"))
    trainer = Trainer(_config(), logdir, seed=0, max_steps=3, device="cpu")
    state = trainer.fit(epochs=2, log_every=1, val_max_batches=1)
    return trainer, state, logdir


def test_trainer_honours_max_steps_and_writes_metrics(fitted):
    trainer, state, logdir = fitted
    assert state.step == 3          # max_steps honoured in mid-epoch
    recs = _records(logdir)
    train = [r for r in recs if r["split"] == "train"]
    val = [r for r in recs if r["split"] == "val"]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["train/loss"]) for r in train)
    assert {"train/loss", "train/loss_simple", "train/loss_vlb"} <= set(train[0])
    assert [r["step"] for r in val] == [2, 3]     # after each epoch
    assert all("val_loss" in r and "val_loss_ema" in r for r in val)


def test_trainer_lr_scaling(fitted, tmp_path):
    trainer, state, _ = fitted
    # accumulate (1) x batch 8 x base 1e-5
    np.testing.assert_allclose(trainer.lr, 8 * 1e-5, rtol=1e-6)
    assert state.optimizer.param_groups[0]["lr"] == trainer.lr
    cfg = _config()
    cfg["scale_lr"] = False
    cfg["lightning"] = {"trainer": {"accumulate_grad_batches": 2,
                                    "max_steps": 1}}
    unscaled = Trainer(cfg, str(tmp_path / "u"), device="cpu")
    assert unscaled.lr == 1e-5 and unscaled.grad_accum == 2
    assert unscaled.max_steps == 1
    state = unscaled.fit(log_every=1)
    assert state.step == 2 and state.optimizer_steps == 1


def test_checkpoint_round_trip_and_resume(fitted, tmp_path):
    trainer, state, logdir = fitted
    ckpt = os.path.join(logdir, "checkpoints")
    assert os.path.isfile(os.path.join(ckpt, "last", "state.pt"))
    best = [n for n in os.listdir(ckpt) if n.startswith("step=")]
    assert best and all("val_loss_ema=" in n for n in best)

    other = Trainer(_config(), logdir, seed=99, max_steps=5, device="cpu")
    restored = other.restore_checkpoint("last")
    assert restored.step == 3
    for a, b in zip(state.params, restored.params):
        assert torch.equal(a, b)
    for a, b in zip(state.ema_params, restored.ema_params):
        assert torch.equal(a, b)
    for a, b in zip(state.params, restored.params):
        sa, sb = state.optimizer.state[a], restored.optimizer.state[b]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"])
        assert torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])
    # EMA shadows cover the trainable parameters only
    assert not any(n.startswith("first_stage") for n in restored.names)
    assert len(restored.ema_params) == len(restored.params) > 100
    # training continues from the restored step, in the epoch it implies
    final = other.fit(epochs=10, log_every=1, val_max_batches=1)
    assert final.step == 5
    assert [r["step"] for r in _records(logdir) if r["split"] == "train"
            ] == [1, 2, 3, 4, 5]


def test_validation_pads_and_masks_the_ragged_tail(tmp_path):
    """11 validation examples at batch 4: three batches, the last padded
    from 3 rows; the means cover all 11 examples."""
    cfg = _config(batch=4, length=8, val_length=11)
    trainer = Trainer(cfg, str(tmp_path / "r"), seed=0, max_steps=1,
                      device="cpu")
    trainer.init_state()
    seen = []
    inner = trainer._eval_step

    def spy(state, batch, seed):
        seen.append((batch["image"].shape[0],
                     batch["_sample_weights"].tolist()))
        return inner(state, batch, seed)

    trainer._eval_step = spy
    val = trainer.validate(seed=0)
    assert [n for n, _ in seen] == [4, 4, 4]
    assert seen[-1][1] == [1.0, 1.0, 1.0, 0.0]
    assert np.isfinite(val["val_loss"]) and np.isfinite(val["val_loss_ema"])
    assert trainer.validate(seed=0, max_batches=0) == {}
    cfg["lightning"] = {"trainer": {"limit_val_batches": 0.5}}
    half = Trainer(cfg, str(tmp_path / "h"), device="cpu")
    assert half._resolve_val_batches(None, half.val_data) == 1


def test_topk_bookkeeping(tmp_path):
    saved, topk = [], []
    save = lambda name: (saved.append(name),
                         os.makedirs(tmp_path / name, exist_ok=True))
    for score, name in ((0.5, "a"), (0.1, "b"), (0.3, "c"), (0.9, "d")):
        save_topk(topk, 2, score, name, save, str(tmp_path))
    assert [n for _, n in topk] == ["b", "c"]
    assert saved == ["a", "b", "c"]            # 0.9 never serialized
    assert sorted(os.listdir(tmp_path)) == ["b", "c"]   # the worst evicted
    keep_all, none = [], []
    for score in (3.0, 1.0, 2.0):
        save_topk(keep_all, -1, score, f"k{score}", lambda n: None, str(tmp_path))
        save_topk(none, 0, score, f"n{score}", saved.append, str(tmp_path))
    assert [s for s, _ in keep_all] == [1.0, 2.0, 3.0] and none == []
    best_high = []
    for score in (1.0, 3.0, 2.0):
        save_topk(best_high, 1, score, f"m{score}", lambda n: None,
                  str(tmp_path), mode="max")
    assert best_high == [(3.0, "m3.0")]


def test_loggers(tmp_path):
    assert build_logger({}, str(tmp_path)) is None
    csv_logger = build_logger(
        {"logger": {"target": "pytorch_lightning.loggers.CSVLogger",
                    "params": {"name": "m"}}}, str(tmp_path))
    assert isinstance(csv_logger, CsvBackend)
    csv_logger.log_metrics({"loss": 1.5}, 3, "train")
    csv_logger.finalize()
    rows = open(tmp_path / "m.csv").read().splitlines()
    assert rows == ["step,split,metric,value", "3,train,loss,1.5"]
    # a logger the port lacks raises: no silent fall back to csv
    with pytest.raises(NotImplementedError):
        build_logger({"logger": {
            "target": "pytorch_lightning.loggers.WandbLogger"}}, str(tmp_path))


def _cached_latents(c):
    """The config trained on cached latents (``first_stage_key: latent``),
    whose image logging stays unported."""
    c["model"]["params"]["first_stage_key"] = "latent"
    spec = dict(SPEC, latent=[[8, 8, 3], "float32"])
    for split in ("train", "validation"):
        c["data"]["params"][split]["params"]["spec"] = spec


def _fit_one_step(t, **kw):
    t.max_steps = 1
    return t.fit(log_every=1, val_max_batches=0, **kw)


@pytest.mark.parametrize("edit,call,error", [
    (lambda c: c["model"]["params"].update(ckpt_path="x.ckpt"), None,
     FileNotFoundError),
    (lambda c: c["model"]["params"]["first_stage_config"]["params"].update(
        ckpt_path="vq.ckpt"), None, FileNotFoundError),
    (lambda c: (_cached_latents(c), c.update(lightning={"callbacks": {
        "image_logger": {"params": {"batch_frequency": 1}}}})),
     _fit_one_step, NotImplementedError),
    (lambda c: c.update(lightning={"logger": {"target": "x.CometLogger"}}),
     None, NotImplementedError),
    (_cached_latents, lambda t: t.fit(image_every=1), NotImplementedError),
    (lambda c: None, lambda t: _fit_one_step(t, profile_at_step=1), None),
    (lambda c: None, lambda t: (t.init_state(), t.log_images(
        next(iter(t.train_data)), 0, n=1, ddim_steps=1)), None),
], ids=["warm-start", "first-stage-ckpt", "image-logger", "unknown-logger",
        "image-every", "profile-at-step", "log-images"])
def test_unported_options_raise(tmp_path, edit, call, error):
    """Each option the trainer once refused wholesale. What stays unported
    raises ``NotImplementedError`` (an unknown logger; image logging of
    cached latents, by the config's logger or ``image_every``); a warm start
    from a missing file ``FileNotFoundError`` before any loader reads it;
    the ported ones (the step profiler, ``log_images``) run
    (tests/test_torch_port_trainer_logging.py holds them against the JAX
    package)."""
    cfg = _config()
    edit(cfg)

    def build_and_call():
        trainer = Trainer(cfg, str(tmp_path / "x"), device="cpu")
        if call is not None:
            call(trainer)

    if error is None:
        build_and_call()
    else:
        with pytest.raises(error):
            build_and_call()


def test_trainer_wants_the_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_config(), str(tmp_path / "c"))


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def _cli(args, timeout=600):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "train_torch.py"),
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=timeout)


def test_train_cli_on_the_cpu_then_resume(tmp_path):
    model = tmp_path / "model.yaml"
    model.write_text(TINY_MEAD_CFG)
    node = json.dumps({"target": "dsml_thesis_tpu_torch.data.SyntheticDataset",
                       "params": {"spec": SPEC, "length": 8}})
    overrides = ["data.params.batch_size=4", "data.params.num_workers=2",
                 f"data.params.train={node}", f"data.params.validation={node}",
                 "model.base_learning_rate=1.0e-5"]
    r = _cli(["--base", str(model), "-t", "--cpu", "--max-steps", "3",
              "--logdir", str(tmp_path / "logs"), "--name", "tiny",
              "--seed", "1", "--log-every", "1", *overrides])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "training done; final step: 3" in r.stdout
    assert "lr: 4.000e-05" in r.stdout
    (run,) = os.listdir(tmp_path / "logs")
    logdir = str(tmp_path / "logs" / run)
    assert run.endswith("_tiny")
    assert os.path.isfile(os.path.join(logdir, "configs", "project.yaml"))
    assert os.path.isfile(os.path.join(logdir, "checkpoints", "last",
                                       "state.pt"))
    assert [x["step"] for x in _records(logdir) if x["split"] == "train"
            ] == [1, 2, 3]

    r = _cli(["--resume", logdir, "-t", "--cpu", "--max-steps", "4",
              "--seed", "1", "--log-every", "1"])
    assert r.returncode == 0, r.stdout + r.stderr
    assert "training done; final step: 4" in r.stdout
    assert [x["step"] for x in _records(logdir) if x["split"] == "train"
            ] == [1, 2, 3, 4]


def test_train_cli_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal cannot be shown")
    model = tmp_path / "model.yaml"
    model.write_text(TINY_MEAD_CFG)
    r = _cli(["--base", str(model), "-t", "--logdir", str(tmp_path / "logs")])
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert not os.path.exists(tmp_path / "logs")
