"""Batched LM serving launcher of the port: continuous batching over fixed slots,
on one device or across the ranks of a ``torch.distributed`` group.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_14b --smoke \
        --requests 8 --prompt-len 32 --gen-len 32 [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite_moe_3b_a800m ...
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2_7b ...
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm_350m ...
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma_3b ...
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper_large_v3 ...
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve --device cpu ...
    ... --coordinator HOST:PORT --num-processes P --process-id i   (each process)

Port of ``repro/launch/serve.py`` for every family: dense (gemma, qwen,
danube, deepseek), MoE (granite-moe, moonshot), VLM (paligemma, served
through its text decode step, as the reference's is), hybrid (zamba2),
xLSTM and the encoder-decoder (whisper). As in the reference, whisper is
served without its encoder: the cache's cross K/V stay zero (the reference
zeroes them again at every admission), so its tokens equal the reference's;
the audio-conditioned decode fills the cross K/V from the encoder first
(``models/whisper.py::fill_cross_cache``). The scheduler packs requests into
fixed slots, keeps a decode position per slot, refills a finished slot from
the queue (continuous batching) and samples greedily; every token, prompt
tokens included, goes through the model's decode step (``Model.serve_step``).
Empty slots decode token 0, as the reference's do; an MoE decode step is
dropless, so they take no expert capacity from live slots. A recurrent
family's state is not protected by position masking: at admission the
server zeroes the new slot (``Model.clear_slot``), snapshots the cache,
teacher-forces the prompt and restores every other slot from the snapshot
(``Model.restore_slots``), the reference's order.

Across ranks (a group the caller made, ``torchrun``'s, or the bootstrap's
flags and ``SSUMM_*`` environment; NCCL on the card, gloo with ``--device
cpu``) it plans ``plan_mesh(P, global_batch=slots, want_model)`` and serves
under the reference's serve table (``make_rules(plan, "serve")``,
``dist/sharding.py``): each rank holds the block of slots the table gives
the reference's device at its position (every slot where the data ranks do
not divide them) and its shard of the parameters and cache. Every rank runs
the same scheduler in lockstep and decodes only its slots; the greedy ids
are all-gathered in rank order after each step, so every rank holds every
request's tokens, which are the one-device server's. The reference plans
``want_model=1``, and so does the launcher by default; ``--want-model m``
adds a model axis over which every family decodes tensor-parallel
(``Model.serve_step(..., tp=, kv_len=)``: a KV cache split over its
positions, flash-decoding, or its KV heads; zamba2's Mamba2 state whole on
every rank, xLSTM's states on their heads, whisper's cross K/V on their KV
heads; ``models/api.py::shard_cache``). Rank 0 prints the reference's
JSON result line plus ``device``, ``decode_steps``, the median decode step,
``world``, ``plan``, a SHA-256 of the served token lists and each rank's
peak device memory. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.types import resolve_device
from repro_torch.dist.data_parallel import DataParallel
from repro_torch.dist.sharding import make_rules
from repro_torch.launch.mesh import join_process_group, mesh_groups
from repro_torch.models.api import build_model, shard_cache, shard_params
from repro_torch.models.common import tree_map
from repro_torch.runtime import plan_mesh


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # int32 [L]
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0


class BatchServer:
    """Fixed-slot continuous-batching server over the Model API.

    Slots advance independently (a decode position per slot), so a request
    can be admitted into a free slot mid-flight: during admission the new
    slot teacher-forces its prompt while occupied slots keep their frozen
    position (their cache line there is rewritten by their own next real
    token, so no state leaks between requests). ``params`` (the port's
    whole parameter tree) replaces the seeded initialisation when given.
    ``step_s`` holds the wall of every decode step, the token ids read back.

    ``rules``: a serve table (``make_rules(plan, "serve")``) across the
    ranks of the default group, this process rank ``rank`` of it (the
    default group's); ``groups``: its ``(data, model)`` sub-groups
    (``launch/mesh.py::mesh_groups``, made here when not given). The rank
    keeps slots ``[slot0, slot0 + local_slots)`` and its shards of the
    parameters and cache; the scheduler is every rank's."""

    def __init__(self, cfg, *, slots: int, max_len: int, seed: int = 0, params=None,
                 device: str | torch.device = "cuda", rules=None, groups=None,
                 rank: int | None = None):
        self.cfg = cfg
        self.model = build_model(cfg, device)
        self.device = self.model.device
        self.slots = slots
        self.max_len = max_len
        self.rank = 0 if rank is None else rank
        self.dp = self.tp = None
        if rules is not None and rules.n_ranks > 1:
            if rank is None:
                self.rank = torch.distributed.get_rank()
            dp, tp = groups if groups is not None else mesh_groups(rules, self.device)
            self.dp = dp if dp.size > 1 else None
            self.tp = tp if tp.size > 1 else None
            self.slot0, stop = rules.block(self.rank, "batch", slots)
            self.local_slots = stop - self.slot0
            self.gather_ids = self.dp is not None and self.local_slots < slots
            self.params = shard_params(self.model, rules, self.rank, params, seed)
            self.cache = shard_cache(self.model, rules, self.rank, slots, max_len)
        else:
            self.local_slots, self.slot0, self.gather_ids = slots, 0, False
            self.params = self.model.init(seed) if params is None else params
            self.cache = self.model.init_cache(slots, max_len)
        self.pos = np.zeros(slots, np.int32)  # next position per slot
        self.active: list[Request | None] = [None] * slots
        self.queue: list[Request] = []
        self.done: list[Request] = []
        self.step_s: list[float] = []

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _run(self, token: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One decode step of this rank's slots; the greedy token of every
        slot (first index on ties), all-gathered from the data ranks."""
        t0 = time.perf_counter()
        mine = slice(self.slot0, self.slot0 + self.local_slots)
        logits, self.cache = self.model.serve_step(self.params, {
            "token": torch.as_tensor(token[mine], dtype=torch.int64, device=self.device),
            "pos": torch.as_tensor(np.minimum(pos[mine], self.max_len - 1), dtype=torch.int64,
                                   device=self.device),
            "cache": self.cache}, self.tp, self.max_len)
        ids = torch.argmax(logits, dim=-1)
        if self.gather_ids:
            ids = self.dp.gather(ids).reshape(-1)
        ids = ids.cpu().numpy()
        self.step_s.append(time.perf_counter() - t0)
        return ids

    def _local(self, s: int) -> int | None:
        """Slot ``s``'s index in this rank's cache, None where it holds it not."""
        s -= self.slot0
        return s if 0 <= s < self.local_slots else None

    def _admit(self) -> None:
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.pop(0)
                self.active[s] = req
                # teacher-force the prompt through the decode path at this
                # slot's own positions; other slots' KV lines are safe by
                # masking. Recurrent state is not: such a family zeroes slot
                # s, snapshots, and restores every other slot afterwards.
                snap = None
                local = self._local(s)
                if self.model.clear_slot is not None:
                    if local is not None:
                        self.cache = self.model.clear_slot(self.cache, local)
                    snap = tree_map(torch.clone, self.cache)
                for i, tok in enumerate(req.prompt):
                    token = np.zeros(self.slots, np.int32)
                    token[s] = tok
                    pos = self.pos.copy()
                    pos[s] = i
                    ids = self._run(token, pos)
                if snap is not None:  # a rank without slot s keeps its snapshot whole
                    self.cache = (snap if local is None else
                                  self.model.restore_slots(self.cache, snap, local))
                self.pos[s] = len(req.prompt)
                req.out.append(int(ids[s]))
                req.t_first = time.perf_counter()

    def step(self) -> bool:
        """One decode step for every active slot. Returns False when idle."""
        self._admit()
        if all(a is None for a in self.active):
            return False
        token = np.zeros(self.slots, np.int32)
        for s, req in enumerate(self.active):
            if req is not None and req.out:
                token[s] = req.out[-1]
        ids = self._run(token, self.pos)
        for s, req in enumerate(self.active):
            if req is None:
                continue
            req.out.append(int(ids[s]))
            self.pos[s] += 1
            if len(req.out) >= req.max_new or self.pos[s] >= self.max_len - 1:
                req.t_done = time.perf_counter()
                self.done.append(req)
                self.active[s] = None
                self.pos[s] = 0  # slot reset for the next admission
        return True


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen2_5_14b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--want-model", type=int, default=1,
                    help="model axis cap (the reference plans 1): tensor-parallel decode")
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of process 0 (default: $SSUMM_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="ranks in the run (default: $SSUMM_NUM_PROCESSES, else one)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's rank (default: $SSUMM_PROCESS_ID)")
    return ap.parse_args(argv)


def serve(args: argparse.Namespace, params=None, cfg=None) -> tuple[dict, BatchServer]:
    """The launcher's run: ``(result, server)``; every rank of a group calls
    it with the same arguments and gets the same tokens (``server.done``).
    ``params`` (the port's whole tree) replaces the seeded initialisation,
    ``cfg`` the model config of ``--arch``/``--smoke``, when given."""
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    own_group, dev = join_process_group(resolve_device(args.device), args.coordinator,
                                        args.num_processes, args.process_id)
    try:
        return _serve(args, cfg, dev, params)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _serve(args, cfg, dev: torch.device, params) -> tuple[dict, BatchServer]:
    world = DataParallel(dev)
    plan = plan_mesh(world.size, global_batch=args.slots, want_model=args.want_model)
    rules = make_rules(plan, "serve")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(args.seed)
    server = BatchServer(cfg, slots=args.slots, max_len=args.max_len, seed=args.seed,
                         params=params, device=dev, rules=rules, rank=world.rank)
    for rid in range(args.requests):
        server.submit(Request(
            rid=rid,
            prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
            max_new=args.gen_len,
        ))
    t0 = time.perf_counter()
    while server.step():
        pass
    wall = time.perf_counter() - t0
    lat = [r.t_done - r.t_submit for r in server.done]
    ttft = [r.t_first - r.t_submit for r in server.done]
    toks = sum(len(r.out) for r in server.done)
    served = json.dumps(sorted((r.rid, r.out) for r in server.done)).encode()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    peaks = world.gather(torch.tensor(peak, dtype=torch.int64, device=dev))
    result = {
        "arch": cfg.name, "requests": len(server.done),
        "tokens": toks, "wall_s": wall,
        "tok_per_s": toks / max(wall, 1e-9),
        "p50_latency_s": float(np.median(lat)) if lat else None,
        "p50_ttft_s": float(np.median(ttft)) if ttft else None,
        "device": str(server.device), "decode_steps": len(server.step_s),
        "p50_decode_step_s": float(np.median(server.step_s)) if server.step_s else None,
        "world": world.size, "plan": dict(zip(plan.axes, plan.shape)),
        "tokens_digest": hashlib.sha256(served).hexdigest(),
        "peak_memory_bytes_per_rank": [int(x) for x in peaks.cpu()] if peak else None,
    }
    return result, server


def main(argv=None, params=None) -> dict:
    """Serve; rank 0 prints the JSON line (every rank returns it)."""
    result, server = serve(parse_args(argv), params)
    if server.rank == 0:
        print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
