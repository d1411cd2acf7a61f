"""The merge gain's plain version against the kernel at the per-rank
web-uk-05 shapes: the port's counterpart of ``scripts/score_bytes.py``.

    PYTHONPATH=src python scripts/torch_score_bytes.py [G C U]

Counts ``kernels/ref.py::merge_gain_ref`` (the plain version, its dense
``[G, C, C, U]`` tensors) op by op on ``meta`` (``launch/costs.py``'s
counter; its boolean-mask writes sized at their all-nonzero upper bound)
and sets its bytes beside the hand kernel's streaming bytes (every operand
read once, ``rel`` and ``red`` written once, ``costs.merge_gain_bytes``),
which is what the dry-run counts at the kernel's call. Defaults: the
reference's per-device shapes, G = 2407, C = 64, U = 128.
"""

from __future__ import annotations

import sys

import torch

from repro_torch.kernels import ref
from repro_torch.launch import costs
from repro_torch.launch.dryrun import assume_all_nonzero

G, C, U = (int(x) for x in (sys.argv[1:4] or (2407, 64, 128)))


def main() -> None:
    f32 = dict(dtype=torch.float32, device="meta")
    args = [torch.empty(G, C, U, **f32), torch.empty(G, C, **f32), torch.empty(G, C, **f32),
            torch.empty(G, C, **f32), torch.empty(G, U, **f32),
            torch.empty(G, C, dtype=torch.int32, device="meta"), torch.empty(G, C, C, **f32),
            torch.empty((), **f32), torch.empty((), **f32)]
    counter = costs.WorkCounter("meta")
    with assume_all_nonzero(), counter:
        ref.merge_gain_ref(*args)
    kernel = costs.merge_gain_bytes(G, C, U)
    print(f"shapes G={G} C={C} U={U}")
    print(f"plain   bytes_accessed: {counter.bytes / 2**30:8.2f} GiB  flops "
          f"{counter.flops:.3e} (products only); peak {counter.peak / 2**30:.2f} GiB; "
          f"{counter.data_dependent} data-dependent op(s) at their upper bound")
    print(f"kernel  streaming bytes: {kernel / 2**30:8.2f} GiB  scoring flops "
          f"{costs.merge_gain_flops(G, C, U):.3e}")
    print(f"inflation: {counter.bytes / kernel:.1f}x")


if __name__ == "__main__":
    main()
