#!/usr/bin/env python3
"""Record ``torch.randint``'s int16 dropout draws on a CUDA card, for
``tests/test_torch_dropout_bits.py``'s model of ATen's Philox mapping.

    python3 tests/record_philox_draws.py [OUT]    # default tests/philox_int16_draws.json

Each case seeds a CUDA generator, sets its Philox offset, draws
``torch.randint(-32768, 32768, (n,), dtype=torch.int16)`` and keeps the
sha256 of the draw's bytes, its first and last 64 values, and the
generator's offset afterwards, with the card's SM count and threads a SM
(ATen's grid depends on both).  Imports torch only.
"""
import hashlib
import json
import os
import sys

import torch

# (seed, offset, n): fewer units than a block; a count that is no multiple of
# 32; seeds above 2**32 and 2**63 and an offset above 2**34; more units than
# one pass of the grid on 132 SMs (256 x 1056 x 4 = 1,081,344), one and two
# passes more
CASES = ((0, 0, 200), (12345, 8, 1000), ((1 << 40) + 7, 4, 70_001),
         (0xFEDCBA9876543210, (1 << 34) + 12, 1_093_689), (987_654_321, 0, 2_200_000))


def record(device: torch.device) -> dict:
    props = torch.cuda.get_device_properties(device)
    out = {"device": torch.cuda.get_device_name(device), "torch": torch.__version__,
           "sms": props.multi_processor_count,
           "max_threads_per_sm": props.max_threads_per_multi_processor, "cases": []}
    for seed, offset, n in CASES:
        gen = torch.Generator(device=device).manual_seed(seed)
        gen.set_offset(offset)
        draw = torch.randint(-(1 << 15), 1 << 15, (n,), generator=gen, device=device,
                             dtype=torch.int16).cpu()
        out["cases"].append({
            "seed": seed, "offset": offset, "n": n,
            "sha256": hashlib.sha256(draw.numpy().astype("<i2").tobytes()).hexdigest(),
            "head": draw[:64].tolist(), "tail": draw[-64:].tolist(),
            "offset_after": gen.get_offset()})
    return out


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("record_philox_draws: needs a CUDA card")
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(os.path.dirname(__file__),
                                                              "philox_int16_draws.json")
    with open(path, "w") as f:
        json.dump(record(torch.device("cuda", 0)), f, indent=1)
        f.write("\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
