"""The port's LM server (``repro_torch.launch.serve``) against the reference's
(``repro.launch.serve``) on the CPU: the scenarios of ``tests/test_serving.py``
(slot counts 1, 2 and 4, ragged prompts, admissions mid-flight) with the
reference's weights carried across give the reference's token lists exactly,
for dense models and for granite's MoE (empty slots route token 0, as the
reference's do: decode is dropless, so they take no capacity from live slots);
the port's own batching invariance; the launcher's JSON line."""

from __future__ import annotations

import functools
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch.serve import BatchServer as RefServer
from repro.launch.serve import Request as RefRequest
from repro.models.api import build_model as ref_build_model

from repro_torch.configs import get_smoke_config
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.launch.serve import BatchServer, Request

torch.set_num_threads(1)

MAX_LEN = 64


@functools.lru_cache(maxsize=None)
def ref_params(arch: str):
    """The reference server's weights (``BatchServer(seed=0)`` draws these)."""
    params = ref_build_model(ref_smoke_config(arch)).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _requests(cls, vocab, n, gen_len=6, seed=0, ragged=False):
    rng = np.random.default_rng(seed)
    return [cls(rid=rid, prompt=rng.integers(0, vocab, 4 + (rid % 3 if ragged else 0))
                .astype(np.int32), max_new=gen_len) for rid in range(n)]


def _drain(server, reqs):
    for r in reqs:
        server.submit(r)
    while server.step():
        pass
    return {r.rid: list(r.out) for r in server.done}


def serve_port(arch, slots, n=5, gen_len=6, ragged=True):
    cfg = get_smoke_config(arch)
    params = lm_params_from_numpy(ref_params(arch), cfg, "cpu")
    server = BatchServer(cfg, slots=slots, max_len=MAX_LEN, params=params, device="cpu")
    return _drain(server, _requests(Request, cfg.vocab, n, gen_len, ragged=ragged))


@functools.lru_cache(maxsize=None)
def serve_reference(arch, slots, n=5, gen_len=6, ragged=True):
    cfg = ref_smoke_config(arch)
    server = RefServer(cfg, slots=slots, max_len=MAX_LEN, seed=0)
    return _drain(server, _requests(RefRequest, cfg.vocab, n, gen_len, ragged=ragged))


@pytest.mark.parametrize("slots", [1, 2, 4])
@pytest.mark.parametrize("arch", ["qwen2_5_14b", "h2o_danube_1_8b", "granite_moe_3b_a800m"])
def test_server_tokens_equal_the_reference(arch, slots):
    want = serve_reference(arch, slots)
    got = serve_port(arch, slots)
    assert got == want


def test_server_tokens_equal_the_reference_without_ragged_prompts():
    assert serve_port("gemma_7b", 2, n=3, ragged=False) == serve_reference(
        "gemma_7b", 2, n=3, ragged=False)


def test_batching_invariance():
    """Outputs with slots=1 (pure sequential) == slots=3 (batched, ragged
    admissions) for identical requests."""
    assert serve_port("qwen2_5_14b", 1) == serve_port("qwen2_5_14b", 3)


def test_all_requests_complete_and_lengths():
    out = serve_port("h2o_danube_1_8b", 2, n=7, gen_len=5)
    assert len(out) == 7
    assert all(len(v) == 5 for v in out.values())


def test_seeded_server_is_deterministic():
    cfg = get_smoke_config("qwen2_5_14b")
    runs = [_drain(BatchServer(cfg, slots=2, max_len=MAX_LEN, seed=3, device="cpu"),
                   _requests(Request, cfg.vocab, 3, ragged=True)) for _ in range(2)]
    assert runs[0] == runs[1]


def test_main_prints_the_reference_keys(capsys):
    res = serve.main(["--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
                      "--prompt-len", "4", "--gen-len", "4", "--max-len", "32"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(res))
    for k in ("arch", "requests", "tokens", "wall_s", "tok_per_s", "p50_latency_s",
              "p50_ttft_s"):
        assert k in res, k
    assert res["arch"] == "qwen2.5-14b" and res["requests"] == 3 and res["tokens"] == 12
    assert res["device"] == "cpu"
    # one decode step a prompt token (4 a request, the last giving its first
    # token), then one a further token: requests 0 and 1 share 3 steps in 2
    # slots, request 2 takes 3 alone: 3·4 + 3 + 3
    assert res["decode_steps"] == 18
