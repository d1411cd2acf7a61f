"""The reference's dry-run cells, for ``tests/test_torch_dryrun.py``.

    PYTHONPATH=src python tests/torch_dryrun_check.py shards PART OUT.json
    PYTHONPATH=src python tests/torch_dryrun_check.py compiled OUT.json

``shards`` sets 512 XLA host devices before jax is imported (as the
reference's ``launch/dryrun.py`` does) and, for every architecture of part
``PART`` (0 or 1, :data:`PARTS`; the two run side by side, ~25 and ~30 s)
× applicable shape on the pod mesh and, for :data:`MULTIPOD_ARCHS`, the
multipod mesh, builds the reference's cell (``repro.launch.lowering.build_cell``;
nothing is lowered) and writes every argument leaf's path, per-device
shard shape (``NamedSharding.shard_shape``) and dtype, and the per-device
argument bytes.

``compiled`` sets 4 host devices and compiles :data:`COMPILED` smoke cells
on a ``(2, 2)`` mesh, writing each one's ``memory_analysis()
.argument_size_in_bytes``.
"""

from __future__ import annotations

import json
import os
import sys

#: one dense and one MoE architecture, also on the multipod mesh
MULTIPOD_ARCHS = ("qwen2_5_14b", "granite_moe_3b_a800m")
#: the architectures of each ``shards`` part
PARTS = (("xlstm_350m", "granite_moe_3b_a800m", "moonshot_v1_16b_a3b", "gemma_7b",
          "deepseek_coder_33b"),
         ("qwen2_5_14b", "h2o_danube_1_8b", "zamba2_7b", "whisper_large_v3", "paligemma_3b"))
#: (arch, shape name, seq, global batch, kind) compiled at (2, 2)
COMPILED = (("h2o_danube_1_8b", "smoke_train", 32, 4, "train"),
            ("granite_moe_3b_a800m", "smoke_decode", 64, 4, "decode"),
            ("zamba2_7b", "smoke_prefill", 64, 2, "prefill"))


def _path(keys, n_args: int) -> str:
    """A jax key path as ``params/layer_0/attn/wq``."""
    names = ("params", "opt", "batch") if n_args == 3 else ("params", "batch")
    out = []
    for i, k in enumerate(keys):
        if i == 0:
            out.append(names[k.idx])
        elif hasattr(k, "key"):
            out.append(str(k.key))
        elif hasattr(k, "name"):
            out.append(str(k.name))
        else:
            out.append(str(k.idx))
    return "/".join(out)


def leaves(cell) -> tuple[list, int]:
    """``[(path, shard shape, dtype)]`` of the cell's arguments, sorted by
    path, and their per-device bytes."""
    import jax
    import numpy as np

    structs = jax.tree_util.tree_flatten_with_path(cell.arg_structs)[0]
    shardings = jax.tree.leaves(cell.arg_shardings, is_leaf=lambda x: hasattr(x, "spec"))
    out, total = [], 0
    for (keys, s), sh in zip(structs, shardings):
        shape = tuple(sh.shard_shape(s.shape))
        out.append((_path(keys, len(cell.arg_structs)), list(shape), str(s.dtype)))
        total += int(np.prod(shape)) * np.dtype(s.dtype).itemsize
    return sorted(out), total


def shards(part: str, out_path: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax

    from repro.configs import applicable_shapes, get_config
    from repro.launch.lowering import build_cell
    from repro.launch.mesh import make_production_mesh

    assert jax.device_count() == 512
    meshes = {"pod": make_production_mesh(), "multipod": make_production_mesh(multi_pod=True)}
    rows = []
    for arch in PARTS[int(part)]:
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            for kind in ("pod", "multipod") if arch in MULTIPOD_ARCHS else ("pod",):
                cell = build_cell(cfg, shape, meshes[kind])
                lv, total = leaves(cell)
                rows.append({"arch": arch, "shape": shape, "mesh": kind, "leaves": lv,
                             "argument_bytes": total})
    with open(out_path, "w") as f:
        json.dump(rows, f)


def compiled(out_path: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax

    from repro.configs import get_smoke_config
    from repro.configs.base import SHAPES, ShapeSpec
    from repro.launch.lowering import build_cell, lower_cell
    from repro.launch.mesh import make_host_mesh

    assert jax.device_count() == 4
    mesh = make_host_mesh((2, 2), ("data", "model"))
    rows = []
    for arch, name, seq, batch, kind in COMPILED:
        SHAPES[name] = ShapeSpec(name, seq, batch, kind)
        cell = build_cell(get_smoke_config(arch), name, mesh)
        ma = lower_cell(cell).compile().memory_analysis()
        lv, total = leaves(cell)
        rows.append({"arch": arch, "shape": name, "leaves": lv, "shard_bytes": total,
                     "argument_size_in_bytes": int(ma.argument_size_in_bytes)})
    with open(out_path, "w") as f:
        json.dump(rows, f)


if __name__ == "__main__":
    {"shards": shards, "compiled": compiled}[sys.argv[1]](*sys.argv[2:])
    print(json.dumps({"ok": True}))
