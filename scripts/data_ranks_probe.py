"""On one card: qwen2.5-14B (LAYERS layers of DTYPE, default 48 bfloat16)
served by one 8-slot server and by 4 data ranks of 2 slots as threads of
this process (the launcher's (4, 1) code: ``BatchServer(rules=)`` with the
id all-gather of ``models/tp_ranks.py::ThreadRank``), 8 requests of 32 + 32
tokens, max_len 4096: the token lists, every decode step's logits against
the 8-slot server's, and one decode step of slots [0, 2) alone against the
8-slot step.

    python3 scripts/data_ranks_probe.py [LAYERS [DTYPE]]
"""
import concurrent.futures, dataclasses, json, os, subprocess, sys, time
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.dist.sharding import make_rules
from repro_torch.dist.tensor_parallel import TensorParallel
from repro_torch.launch.serve import BatchServer, Request
from repro_torch.models.tp_ranks import ThreadRank, _Shared
from repro_torch.runtime import plan_mesh

def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 48
    dtype = sys.argv[2] if len(sys.argv) > 2 else "bfloat16"
    cfg = dataclasses.replace(get_config("qwen2_5_14b"), n_layers=layers, dtype=dtype)
    print(f"{layers} layers, {dtype}")
    dev = torch.device("cuda")
    one = BatchServer(cfg, slots=8, max_len=4096, device=dev)
    params = one.params

    def stream():
        rng = np.random.default_rng(0)
        return [Request(rid=r, prompt=rng.integers(0, cfg.vocab, 32).astype(np.int32), max_new=32)
                for r in range(8)]

    # one decode step: slots [0, 2) alone against the 8-slot step
    gen = torch.Generator(device=dev); gen.manual_seed(2)
    token = torch.randint(0, cfg.vocab, (8,), device=dev, generator=gen)
    pos = torch.arange(8, device=dev) * 7
    with torch.no_grad():
        all8, _ = one.model.serve_step(params, {"token": token, "pos": pos, "cache": one.model.init_cache(8, 4096)})
        two, _ = one.model.serve_step(params, {"token": token[:2], "pos": pos[:2], "cache": one.model.init_cache(2, 4096)})
    print(f"step of slots [0, 2) alone vs in 8 (max_len 4096, {layers} layers): equal {torch.equal(two, all8[:2])}, "
          f"max diff / max |logit| {float((two - all8[:2]).abs().max() / all8[:2].abs().max()):.3e}")

    def recording(server):
        log, decode = [], server.model.decode
        def rec(*a):
            lg, c = decode(*a)
            log.append(lg.float().cpu())
            return lg, c
        server.model = dataclasses.replace(server.model, decode=rec)
        return log

    one_log = recording(one)
    t0 = time.perf_counter()
    for r in stream():
        one.submit(r)
    while one.step():
        pass
    want = {r.rid: r.out for r in one.done}
    print(f"8-slot server: {time.perf_counter() - t0:.1f} s")

    rules = make_rules(plan_mesh(4, global_batch=8, want_model=1), "serve")
    shared = _Shared(4)
    servers = [BatchServer(cfg, slots=8, max_len=4096, device=dev, params=params, rules=rules, rank=r,
                           groups=(ThreadRank(dev, shared, r, rules), TensorParallel(dev)))
               for r in range(4)]

    def run(s):
        try:
            for r in stream():
                s.submit(r)
            while s.step():
                pass
            return {r.rid: r.out for r in s.done}
        except BaseException:
            shared.barrier.abort()
            raise

    logs = [recording(s) for s in servers]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        got = [f.result() for f in [pool.submit(run, s) for s in servers]]
    print(f"4 data ranks as threads: {time.perf_counter() - t0:.1f} s; slots {[(s.slot0, s.local_slots) for s in servers]}")
    same = [g == want for g in got]
    first = {rid: next((i for i, (a, b) in enumerate(zip(want[rid], got[0][rid])) if a != b), None) for rid in want}
    worst, equal_steps = 0.0, 0
    for i, ref in enumerate(one_log):
        if i >= len(logs[0]):
            break
        cat = torch.cat([lg[i] for lg in logs])
        equal_steps += bool(torch.equal(cat, ref))
        worst = max(worst, float((cat - ref).abs().max() / ref.abs().max()))
    print(f"steps compared {min(len(one_log), len(logs[0]))}, bit-equal {equal_steps}, "
          f"max |4 ranks - 8 slots| / max |logit| {worst:.3e}")
    print(json.dumps({"ranks_equal_to_each_other": all(g == got[0] for g in got), "equal_to_8_slot": same,
                      "first_differing_token_by_request": first}))


if __name__ == "__main__":
    main()
