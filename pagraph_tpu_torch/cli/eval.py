"""Checkpoint-replay evaluation CLI (the port of ``pagraph_tpu/cli/eval.py``;
reference: examples/eval.py).

    python -m pagraph_tpu_torch.cli.eval --dataset <dir> --ckpt-dir checkpoint \\
        --arch gcn --n-layers 1 --n-hidden 32 [--interval 5] [--cpu-devices 1]

Reads the port's own checkpoints (``train/checkpoint.py``: ``torch.save``
files under the JAX package's names), restores each into a fresh state on
the card (on the CPU under ``--cpu-devices``) and prints each epoch's
accuracy, then one JSON line ``{"results": {epoch: accuracy}}``.
"""
from __future__ import annotations

import argparse
import json

from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description="pagraph_tpu_torch checkpoint eval")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--ckpt-dir", type=str, default="checkpoint")
    p.add_argument("--interval", type=int, default=1,
                   help="evaluate every Nth checkpoint")
    p.add_argument("--split", choices=["test", "val", "train"], default="test")
    p.add_argument("--backend", choices=["host", "device", "auto"],
                   default="auto",
                   help="full-graph aggregation: host scipy SpMM, window "
                        "reductions on the card, or auto (device at >=2M "
                        "edges — the scale default)")
    common.add_model_flags(p)
    common.add_device_flags(p)
    args = p.parse_args(argv)

    common.setup_platform()
    from ..data.formats import load_dataset
    from ..train.checkpoint import evaluate_checkpoints
    from ..utils.device import resolve_device

    device = resolve_device(common.run_device(args))   # no card, no --cpu-devices: raises
    ds = load_dataset(args.dataset)
    cfg = common.inference_config(args, feat_dim=ds.feat_dim, n_classes=ds.num_classes)
    mask = getattr(ds, f"{args.split}_mask")
    results = evaluate_checkpoints(
        cfg, args.ckpt_dir, ds.graph, ds.features, ds.labels, mask,
        interval=args.interval, backend=args.backend, device=device,
    )
    for epoch, acc in sorted(results.items()):
        print(f"epoch {epoch}: {args.split} accuracy {acc:.4f}")
    print(json.dumps({"results": results}))
    return results


if __name__ == "__main__":
    main()
