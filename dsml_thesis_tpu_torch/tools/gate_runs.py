"""The fidelity gate on weights the port trained itself, and on random
weights, on the GPU.

    python -m dsml_thesis_tpu_torch.tools.gate_runs --workdir DIR \
        [--config configs/latent-diffusion/mead-256-ldm-f4-fullattn.yaml]
        [--train-steps 300] [--gate-steps 50 --frames 4 --batch 2]

First ``scripts/train_torch.py``'s ``main()`` trains the config at its YAML's
batch and full width for ``--train-steps`` optimizer steps from seed 0 on
``SyntheticDataset`` at the config's shapes (the card's machine has no
image decoder for MEAD's frames), writing its ``last`` checkpoint under
``--workdir``. Then ``scripts/fidelity_gate_torch.py``'s ``main()`` runs with
``--isolate-flash --csim`` four times: on those weights and on random
weights from seed 0, each as the config is (the tanh GELU) and with
``--ab-env DSML_GELU_EXACT=1`` (the erf GELU in the flagship run). One JSON
line for the training (losses, seconds) and one for each gate run (the
gate's own line with its wall seconds), then the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import time

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def synthetic_nodes(cfg, length):
    """SyntheticDataset nodes of the talking-face config's five fields at
    its frame size (train: ``length`` examples; validation: one batch)."""
    p = cfg["model"]["params"]
    size = p["first_stage_config"]["params"]["ddconfig"]["resolution"]
    c2 = p["cond_stage_config_2"]["params"]
    frame = [[size, size, 3], "float32"]
    spec = {"image": frame, "masked_image": frame, "identity": frame,
            "class_label": [[], "int32"],
            "audio": [[c2["seq_len"], c2["subspace_dim"]], "float32"]}
    target = "dsml_thesis_tpu_torch.data.SyntheticDataset"
    batch = cfg["data"]["params"]["batch_size"]
    return ({"target": target, "params": {"spec": spec, "length": length}},
            {"target": target,
             "params": {"spec": spec, "length": batch, "seed": 1000}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--config", default=os.path.join(
        HERE, "configs", "latent-diffusion", "mead-256-ldm-f4-fullattn.yaml"))
    ap.add_argument("--train-steps", type=int, default=300)
    ap.add_argument("--gate-steps", type=int, default=50)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="on the CPU (a dry run at a tiny config)")
    args = ap.parse_args(argv)

    import torch

    from ..config import load_config

    cfg = load_config([args.config])
    batch = cfg["data"]["params"]["batch_size"]
    res = cfg["model"]["params"]["first_stage_config"]["params"][
        "ddconfig"]["resolution"]
    cpu = ["--cpu"] if args.cpu else []
    sync = (lambda: None) if args.cpu else torch.cuda.synchronize
    train, val = synthetic_nodes(cfg, args.train_steps * batch)
    sync()
    t0 = time.monotonic()
    trainer = _script("train_torch").main([
        "--base", args.config, "-t", "--max-steps", str(args.train_steps),
        "--logdir", os.path.join(args.workdir, "train"), "--name", "gate",
        "--seed", "0", "--no-test", "--log-every", "1",
        f"data.params.train={json.dumps(train)}",
        f"data.params.validation={json.dumps(val)}",
        "lightning.modelcheckpoint.params.save_top_k=0", *cpu])
    sync()
    train_s = time.monotonic() - t0
    with open(os.path.join(trainer.logdir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in recs if r["split"] == "train"]
    vals = [r for r in recs if r["split"] == "val"]
    ckpt = os.path.join(trainer.logdir, "checkpoints", "last")
    print(json.dumps({
        "phase": "train", "config": os.path.relpath(args.config, HERE),
        "steps": len(losses), "batch": batch, "seconds": round(train_s, 3),
        "loss_first10": float(sum(losses[:10]) / len(losses[:10])),
        "loss_last10": float(sum(losses[-10:]) / len(losses[-10:])),
        "losses_every25": losses[::25], "val": vals[-1] if vals else None,
        "ckpt": ckpt}), flush=True)
    del trainer
    if not args.cpu:
        torch.cuda.empty_cache()

    gate = _script("fidelity_gate_torch")
    for weights in (ckpt, None):
        for ab in (None, "DSML_GELU_EXACT=1"):
            argv = ["--config", args.config, "--res", str(res),
                    "--steps", str(args.gate_steps),
                    "--frames", str(args.frames),
                    "--batch", str(args.batch), "--isolate-flash", "--csim",
                    *cpu]
            argv += ["--ckpt", weights] if weights else []
            argv += ["--ab-env", ab] if ab else []
            t0 = time.monotonic()
            result = gate.main(argv)
            print(json.dumps({"phase": "gate",
                              "weights": "trained" if weights else "random",
                              "gelu": "erf" if ab else "tanh",
                              "wall_seconds": round(time.monotonic() - t0, 3),
                              **result}), flush=True)
            if not args.cpu:
                torch.cuda.empty_cache()
    if args.cpu:
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
