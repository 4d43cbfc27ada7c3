"""Batch inference CLI: full-graph predictions from a trained checkpoint (the
port of ``pagraph_tpu/cli/infer.py``).

    python -m pagraph_tpu_torch.cli.infer --dataset <dir> --ckpt-dir checkpoint \\
        --arch graphsage --n-hidden 32 --out preds.npy [--save-logits] \\
        [--backend device] [--cpu-devices 1]

Loads the newest (or ``--epoch``) checkpoint of the port's own
(``train/checkpoint.py``) into a state on the card (on the CPU under
``--cpu-devices``), runs exact full-neighborhood layer-wise inference over
EVERY vertex (``models/inference.full_graph_logits``, host or device
backend) and writes the argmax predictions — the serving-side complement of
the reference's eval.py, which only prints test accuracy (reference:
examples/eval.py:28-46).  Prints one JSON line: the epoch, the vertex
count, the output path and the validation and test accuracies.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from . import common


def main(argv=None):
    p = argparse.ArgumentParser(description="pagraph_tpu_torch batch inference")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--ckpt-dir", type=str, default="checkpoint")
    p.add_argument("--epoch", type=int, default=None,
                   help="checkpoint epoch; default = newest")
    p.add_argument("--out", type=str, required=True,
                   help="output .npy for int64 predictions [N]")
    p.add_argument("--save-logits", action="store_true",
                   help="also write <out>.logits.npy (float32 [N, C])")
    p.add_argument("--backend", choices=["host", "device"], default="host")
    common.add_model_flags(p)
    common.add_device_flags(p)
    args = p.parse_args(argv)

    common.setup_platform()
    from ..data.formats import load_dataset
    from ..models.inference import full_graph_logits
    from ..train.checkpoint import list_checkpoints, restore_checkpoint
    from ..train.state import create_state
    from ..utils.device import resolve_device

    device = resolve_device(common.run_device(args))   # no card, no --cpu-devices: raises
    ds = load_dataset(args.dataset)
    cfg = common.inference_config(args, feat_dim=ds.feat_dim, n_classes=ds.num_classes)
    model = cfg.model
    have = list_checkpoints(args.ckpt_dir, model.arch)
    if not have:
        raise SystemExit(f"no {model.arch} checkpoints under {args.ckpt_dir}")
    epoch = args.epoch if args.epoch is not None else have[-1]
    if epoch not in have:
        raise SystemExit(
            f"no epoch-{epoch} checkpoint under {args.ckpt_dir}; "
            f"available: {have}")
    state = restore_checkpoint(args.ckpt_dir, model.arch, epoch,
                               create_state(cfg, device=device))

    logits = full_graph_logits(state.model, model, ds.graph, ds.features,
                               backend=args.backend)
    preds = logits.argmax(axis=1).astype(np.int64)
    np.save(args.out, preds)
    if args.save_logits:
        np.save(args.out + ".logits.npy", logits.astype(np.float32))
    summary = {
        "epoch": int(epoch),
        "num_vertices": int(preds.shape[0]),
        "out": args.out,
    }
    for split in ("val", "test"):
        mask = np.asarray(getattr(ds, f"{split}_mask"), dtype=bool)
        if mask.any():
            summary[f"{split}_acc"] = float((preds[mask] == ds.labels[mask]).mean())
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
