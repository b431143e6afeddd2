#!/usr/bin/env python3
"""CSIM of the PyTorch port: the mean cosine similarity of identity
embeddings between two image directories (the port's ``scripts/csim.py``).

    python3 scripts/csim_torch.py --dir-a <generated> --dir-b <source> \
        --weights backbone.pth [--network iresnet18] [--batch 32] [--cpu]

Images (``*.jpg``, ``*.png``, ``*.npy`` arrays in [-1, 1]) are paired in
sorted order, read at 112 px by the port's ``load_image`` (the native
decoder under ``DSML_NATIVE_IMAGE=1``) and embedded by the tower that
``--network`` names: ``iresnet18/34/50/100/200``, ``ir_se50`` / ``ir50``,
``mbf`` / ``mbf_large``, ``vit_t/s/b``, with the weights of the reference
checkpoint ``--weights`` (nothing else is read). Prints the mean and the
standard deviation of the pairs' cosines. It runs on the card; without one
it fails unless ``--cpu`` is given. ``main()`` returns the cosines.
"""
import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from dsml_thesis_tpu_torch import cli


def build_tower(weights: str, network: str = "iresnet18", device=None):
    """A reference checkpoint and a network name -> an embedding function
    ([N, 112, 112, 3] in [-1, 1] on ``device`` -> [N, D])."""
    from dsml_thesis_tpu_torch.convert import torch_load
    from dsml_thesis_tpu_torch.models import insight_face as inf
    from dsml_thesis_tpu_torch.models.arcface import (_BLOCKS,
                                                      convert_iresnet, iresnet)

    sd = torch_load(weights)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if network in _BLOCKS:
        model = iresnet(network)
        model.load_state_dict(convert_iresnet(sd, _BLOCKS[network]))
    elif network in ("ir_se50", "ir50"):
        model = inf.IRSE(num_layers=50,
                         mode="ir_se" if network == "ir_se50" else "ir",
                         affine="output_layer.4.weight" in sd)
        model.load_state_dict(inf.convert_irse(sd, num_layers=50))
    elif network in ("mbf", "mbf_large"):
        blocks = (1, 4, 6, 2) if network == "mbf" else (2, 8, 12, 4)
        model = inf.MobileFaceNet(blocks=blocks,
                                  scale=2 if network == "mbf" else 4)
        model.load_state_dict(inf.convert_mobilefacenet(sd, blocks))
    elif network in inf.FACE_VIT_FACTORIES:
        kw = inf.FACE_VIT_FACTORIES[network]
        model = inf.FaceViT(**kw, qkv_bias="blocks.0.attn.qkv.bias" in sd)
        model.load_state_dict(inf.convert_face_vit(sd, depth=kw["depth"]))
    else:
        raise SystemExit(f"unknown network {network!r}")
    return inf.make_embed_fn(model, device)


def list_images(d):
    return sorted(glob.glob(os.path.join(d, "*.jpg"))
                  + glob.glob(os.path.join(d, "*.png"))
                  + glob.glob(os.path.join(d, "*.npy")))


def load112(path):
    """An image file, or an ``.npy`` array in [-1, 1] ([H, W, 3] or its
    first of a stack), as float32 [112, 112, 3] in [-1, 1]."""
    from dsml_thesis_tpu_torch.data import load_image

    if path.endswith(".npy"):
        from PIL import Image

        arr = np.load(path)
        if arr.ndim == 4:
            arr = arr[0]
        img = Image.fromarray(((arr + 1) * 127.5).astype(np.uint8)).resize(
            (112, 112))
        return np.asarray(img, np.float32) / 127.5 - 1.0
    return load_image(path, 112)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dir-a", required=True)
    ap.add_argument("--dir-b", required=True)
    ap.add_argument("--weights", required=True,
                    help="the tower's reference checkpoint")
    ap.add_argument("--network", default="iresnet18",
                    help="iresnet18/34/50/100/200, ir_se50/ir50, "
                         "mbf/mbf_large, vit_t/s/b")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = cli.device_of(args.cpu)

    from dsml_thesis_tpu_torch.metrics import cosine_similarity

    embed = build_tower(args.weights, args.network, device)
    paths_a, paths_b = list_images(args.dir_a), list_images(args.dir_b)
    n = min(len(paths_a), len(paths_b))
    if len(paths_a) != len(paths_b):
        print(f"note: pairing first {n} of {len(paths_a)}/{len(paths_b)} "
              "images")
    paths_a, paths_b = paths_a[:n], paths_b[:n]
    sims = []
    for s in range(0, n, args.batch):
        a, b = (torch.from_numpy(np.stack(
            [load112(p) for p in ps[s:s + args.batch]])).to(device)
            for ps in (paths_a, paths_b))
        sims.extend(cosine_similarity(embed(a), embed(b)).cpu().tolist())
    print(f"CSIM over {len(sims)} pairs: {np.mean(sims):.4f} "
          f"± {np.std(sims):.4f}")
    return sims


if __name__ == "__main__":
    main()
