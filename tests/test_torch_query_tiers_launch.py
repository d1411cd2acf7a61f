"""The query server's ``--distributed --tier {replicated, partitioned}``.

At a world of one (the launcher makes it, in this process, and ends it) and
at 2 gloo ranks (spawned, joined through a ``file://`` store), both tiers
serve the local mode's stream with the local mode's digest, and rank 0
prints the reference's ``mode``, ``owner_counts`` and ``partition_stats``.
"""

import json

import pytest
import torch

import torch_query_tiers_check as tqc

from repro_torch.launch import query_serve

ARGS = ["--dataset", "ego-facebook", "--scale", "0.05", "--T", "4", "--k-frac", "0.4",
        "--requests", "40", "--batch", "16", "--seed", "2", "--device", "cpu",
        "--queries", "degree,adjacency,pagerank,triangle,khop,cut,conductance"]
TIERS = {"replicated": ("routed", []), "partitioned": ("partitioned", []),
         "partitioned-dense": ("partitioned", ["--dense-row-nnz", "2"])}

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def local():
    return query_serve.main(ARGS)


def _argv(tier: str) -> list:
    return ARGS + ["--distributed", "--tier", tier.split("-")[0]] + TIERS[tier][1]


def _check(rec: dict, local: dict, tier: str, world: int) -> None:
    assert rec["answers_digest"] == local["answers_digest"], tier
    assert rec["mode"] == f"{TIERS[tier][0]}{{'ranks': {world}}}"
    assert rec["backend"] == "gloo" and rec["requests"] == local["requests"]
    assert len(rec["owner_counts"]) == world
    assert sum(rec["owner_counts"]) == local["blocks"]["S"] == rec["blocks"]["S"]
    assert rec["pagerank_iterations"] == local["pagerank_iterations"]
    assert rec["triangle_wedges"] == local["triangle_wedges"]
    stats = rec.get("partition_stats")
    assert (stats is None) == (tier == "replicated")
    if stats is not None:
        assert stats["devices"] == world and len(stats["resident_bytes_per_device"]) == world
        assert (stats["dense_rows"] > 0) == (tier == "partitioned-dense")


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_a_world_of_one_gives_the_local_digest(local, tier, capsys):
    capsys.readouterr()
    rec = query_serve.main(_argv(tier))
    assert json.loads(capsys.readouterr().out) == json.loads(json.dumps(rec))
    _check(rec, local, tier, 1)
    assert not torch.distributed.is_initialized()  # the group it made, it ended


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_two_gloo_ranks_give_the_local_digest(local, tier):
    out = tqc.spawn(2, "case_launch", argv=_argv(tier))
    assert out[1] == {}  # rank 0 prints for every rank
    _check(out[0], local, tier, 2)
