#!/usr/bin/env python3
"""FID / IS / KID / PRC between a generated and a reference image set, of
the PyTorch port (the port's ``scripts/fid_metrics.py``).

    python3 scripts/fid_metrics_torch.py --gen out/samples --ref data/val \
        (--inception-ckpt pt_inception-2015-12-05-6726825d.pth
         | --torch-extractor model.pt [--isc]) [--size 299 --batch 32
        --prc-k 3] [--cpu]

The images of each directory (``*.jpg`` / ``*.png``) are squashed to
``--size`` by Pillow's bilinear resize and go through a feature extractor
in batches of ``--batch``: the FID InceptionV3 of
``dsml_thesis_tpu_torch/metrics/inception.py`` holding the
``--inception-ckpt`` state_dict (pt_inception / torchvision layout; 2048-d
pool features, 1008 logits for IS; resized to 299 inside, without TF32),
or a model of the user's (``--torch-extractor``: TorchScript for ``.pt``,
else a pickled module; fed [0, 1] RGB NCHW at ``--size``, also without
TF32; its outputs are the features, and with ``--isc`` also the logits of
IS). Prints FID, KID (mean ± std over 100 subsets), PRC (precision, recall
at k = ``--prc-k``) and, with logits, IS. It runs on the card; without one
it fails unless ``--cpu`` is given. ``main()`` returns the numbers.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from dsml_thesis_tpu_torch import cli


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--gen", required=True)
    ap.add_argument("--ref", required=True)
    ap.add_argument("--inception-ckpt", default=None,
                    help="pt_inception / torchvision InceptionV3 state_dict")
    ap.add_argument("--torch-extractor", default=None,
                    help="TorchScript (.pt) or pickled feature extractor "
                         "([0, 1] RGB input)")
    ap.add_argument("--size", type=int, default=299)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--prc-k", type=int, default=3)
    ap.add_argument("--isc", action="store_true",
                    help="(--torch-extractor) its output is class logits")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    if not args.inception_ckpt and not args.torch_extractor:
        ap.error("one of --inception-ckpt / --torch-extractor required")
    device = cli.device_of(args.cpu)

    from dsml_thesis_tpu_torch.metrics.fid import (compute_features,
                                                   fid_from_features,
                                                   inception_score,
                                                   kid_from_features,
                                                   precision_recall)
    from dsml_thesis_tpu_torch.metrics.image import full_fp32

    logits_all = None
    if args.inception_ckpt:
        from dsml_thesis_tpu_torch.metrics.inception import (
            convert_fid_inception, make_feature_fn)

        sd = torch.load(args.inception_ckpt, map_location="cpu",
                        weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        feature_fn = make_feature_fn(convert_fid_inception(sd).to(device))
        logits = {}

        def make_extract(tag):
            def extract(imgs_m11):
                pool, lg = feature_fn(imgs_m11)
                logits.setdefault(tag, []).append(lg.cpu().numpy())
                return pool.cpu().numpy()
            return extract

        feats_gen = compute_features(args.gen, make_extract("gen"),
                                     batch=args.batch, size=args.size)
        feats_ref = compute_features(args.ref, make_extract("ref"),
                                     batch=args.batch, size=args.size)
        logits_all = np.concatenate(logits["gen"])
    else:
        model = (torch.jit.load(args.torch_extractor, map_location="cpu")
                 if args.torch_extractor.endswith(".pt")
                 else torch.load(args.torch_extractor, map_location="cpu",
                                 weights_only=False))
        model = model.to(device).eval()

        @torch.no_grad()
        def extract(imgs_m11):
            x = torch.from_numpy(((imgs_m11 + 1) / 2).transpose(0, 3, 1, 2))
            x = torch.nn.functional.interpolate(
                x.to(device), size=args.size, mode="bilinear",
                align_corners=False)
            with full_fp32():
                feats = model(x)
            return feats.float().cpu().numpy().reshape(len(imgs_m11), -1)

        feats_gen = compute_features(args.gen, extract, batch=args.batch,
                                     size=args.size)
        feats_ref = compute_features(args.ref, extract, batch=args.batch,
                                     size=args.size)
        if args.isc:
            logits_all = feats_gen

    out = {"fid": fid_from_features(feats_ref, feats_gen)}
    print(f"FID: {out['fid']:.4f}")
    out["kid"] = kid_from_features(feats_ref, feats_gen)
    print(f"KID: {out['kid'][0]:.6f} ± {out['kid'][1]:.6f}")
    out["prc"] = precision_recall(feats_ref, feats_gen, k=args.prc_k)
    print(f"PRC: precision {out['prc'][0]:.4f} recall {out['prc'][1]:.4f}")
    if logits_all is not None:
        e = np.exp(logits_all - logits_all.max(axis=1, keepdims=True))
        out["is"] = inception_score(e / e.sum(axis=1, keepdims=True))
        print(f"IS: {out['is'][0]:.4f} ± {out['is'][1]:.4f}")
    return out


if __name__ == "__main__":
    main()
