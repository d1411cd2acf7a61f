"""The port's checkpoint manager, preemption guard, straggler monitor and
the permutation sources' state, on the CPU: the cases of
tests/test_runtime.py (checkpoint, straggler) against
``repro_torch.runtime``, plus directories written by one package and
restored by the other, the ``SummaryState`` leaves, and the positions of the
permutation sources."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime import CheckpointManager as RefCheckpointManager

from repro_torch.core.convert import ReplayPermutations
from repro_torch.core.engine import _state_on_disk
from repro_torch.core.shingles import TorchPermutations
from repro_torch.core.types import SummaryState, init_state
from repro_torch.runtime import CheckpointManager, PreemptionGuard, StragglerMonitor

torch.set_num_threads(1)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.as_tensor(rng.standard_normal((4, 8)), dtype=torch.float32),
        "nested": {"b": torch.as_tensor(rng.standard_normal(3), dtype=torch.float32),
                   "step": torch.tensor(7, dtype=torch.int32)},
    }


def _zeros_like(tree):
    return {"w": torch.zeros(4, 8), "nested": {"b": torch.zeros(3),
                                               "step": torch.tensor(0, dtype=torch.int32)}}


def _assert_tree_equal(got, want):
    assert torch.equal(got["w"], want["w"])
    assert torch.equal(got["nested"]["b"], want["nested"]["b"])
    assert torch.equal(got["nested"]["step"], want["nested"]["step"])


# ---------------------------------------------------------------------------
# checkpoint manager (the cases of tests/test_runtime.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("how", ["save", "save_async"])
def test_checkpoint_roundtrip(tmp_path, how):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    getattr(mgr, how)(10, tree, extra={"loss": 1.5})
    mgr.wait()
    got, step, extra = mgr.restore(_zeros_like(tree))
    assert step == 10 and extra["loss"] == 1.5
    _assert_tree_equal(got, tree)
    got, _, _ = mgr.restore(_zeros_like(tree), step=10, device="cpu")
    _assert_tree_equal(got, tree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_params_and_adamw_state_roundtrip(tmp_path, dtype):
    """A trainer's ``(params, AdamWState)``: the NamedTuple comes back as
    itself (rebuilt from its fields), every leaf in its type, bit for bit; a
    bfloat16 leaf is written as its 2-byte patterns, as the reference's
    ``np.save`` writes one."""
    from repro_torch.optim import AdamWState, adamw_init

    rng = np.random.default_rng(1)
    params = {"embed": torch.as_tensor(rng.standard_normal((6, 4))).to(dtype),
              "ln": {"scale": torch.as_tensor(rng.standard_normal(4), dtype=torch.float32)}}
    opt = adamw_init(params)
    opt = AdamWState(step=opt.step + 3, mu={k: v for k, v in opt.mu.items()},
                     nu=opt.nu)
    opt.mu["embed"].normal_(generator=torch.Generator().manual_seed(2))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(3, (params, opt))
    mgr.wait()
    template = ({"embed": torch.zeros_like(params["embed"]),
                 "ln": {"scale": torch.zeros(4)}}, adamw_init(params))
    (got_p, got_opt), step, _ = mgr.restore(template)
    assert step == 3 and type(got_opt) is AdamWState
    assert got_opt.step.dtype == torch.int32 and int(got_opt.step) == 3
    assert got_p["embed"].dtype == dtype and got_opt.mu["embed"].dtype == torch.float32
    for a, b in ((got_p["embed"], params["embed"]), (got_p["ln"]["scale"], params["ln"]["scale"]),
                 (got_opt.mu["embed"], opt.mu["embed"]), (got_opt.nu["ln"]["scale"],
                                                          opt.nu["ln"]["scale"])):
        assert torch.equal(a, b)


def test_checkpoint_keep_n_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(s))
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    got, step, _ = mgr.restore(_zeros_like(_tree()))
    assert step == 4
    _assert_tree_equal(got, _tree(4))


def test_checkpoint_ignores_uncommitted(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(5, _tree())
    os.makedirs(tmp_path / "step_0000000009")  # a crash mid-write: no COMMIT
    assert mgr.latest_step() == 5


@pytest.mark.parametrize("template,error", [
    ({"w": torch.zeros(3, 3)}, ValueError),  # shape mismatch
    ({"w": torch.zeros(2, 2), "v": torch.zeros(1)}, KeyError),  # missing leaf
])
def test_checkpoint_restore_rejects_another_tree(tmp_path, template, error):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.zeros(2, 2)})
    with pytest.raises(error):
        mgr.restore(template)


def test_checkpoint_restore_with_nothing_committed(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore({"w": torch.zeros(1)})


def test_checkpoint_tmp_dir_ignored_and_gced(tmp_path):
    """A crash mid-write leaves only a ``.tmp-`` directory: restore never
    sees it, and the next successful save removes it."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(4, _tree())
    junk = tmp_path / ".tmp-9"
    junk.mkdir()
    (junk / "w.npy").write_bytes(b"partial garbage")
    assert mgr.latest_step() == 4
    _, step, _ = mgr.restore(_zeros_like(_tree()))
    assert step == 4
    mgr.save(5, _tree(1))
    assert not junk.exists()
    assert mgr.all_steps() == [4, 5]


def test_checkpoint_save_stats_and_step_bytes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    mgr.save_async(2, tree, extra={"t_next": 3})
    mgr.wait()
    st = mgr.save_stats[2]
    assert st["snapshot_wall_s"] > 0.0
    assert st["write_wall_s"] > 0.0
    assert st["bytes"] == mgr.step_bytes(2) > 0
    leaf_bytes = sum(x.numel() * x.element_size()
                     for x in (tree["w"], tree["nested"]["b"], tree["nested"]["step"]))
    assert st["bytes"] > leaf_bytes  # every leaf is on disk, and the manifest
    assert mgr.step_bytes(99) == 0


def test_snapshot_is_a_copy(tmp_path):
    """A leaf changed in place after ``save_async`` returns is saved as it was."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    want = tree["w"].clone()
    mgr.save_async(1, tree)
    tree["w"].add_(1.0)
    mgr.wait()
    got, _, _ = mgr.restore(_zeros_like(tree))
    assert torch.equal(got["w"], want)


def test_writer_error_is_raised_by_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"x": torch.zeros(2)}, extra={"bad": object()})  # not JSON
    with pytest.raises(TypeError):
        mgr.wait()


# ---------------------------------------------------------------------------
# one on-disk layout for both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("template", ["tensors", "numpy"])
def test_reference_directory_restores_through_the_port(tmp_path, template):
    ref = RefCheckpointManager(str(tmp_path), keep=2)
    tree = _tree(3)
    ref.save(6, jax.tree.map(lambda x: jnp.asarray(x.numpy()), tree), extra={"a": [1, 2]})
    like = _zeros_like(tree)
    if template == "numpy":
        like = {"w": np.zeros((4, 8), np.float32),
                "nested": {"b": np.zeros(3, np.float32), "step": np.int32(0)}}
    got, step, extra = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 6 and extra == {"a": [1, 2]}
    if template == "numpy":
        assert isinstance(got["w"], np.ndarray) and got["nested"]["step"].dtype == np.int32
        got = {"w": torch.as_tensor(got["w"]), "nested": {
            "b": torch.as_tensor(got["nested"]["b"]),
            "step": torch.as_tensor(got["nested"]["step"])}}
    _assert_tree_equal(got, tree)


def test_a_reference_bfloat16_leaf_restores_through_the_port(tmp_path):
    """The reference's ``np.save`` writes a bfloat16 leaf as its 2-byte
    patterns; the port reads them back into a bfloat16 tensor, and writes its
    own the same way (the same 2-byte patterns on disk)."""
    x = np.random.default_rng(5).standard_normal((3, 5)).astype(np.float32)
    RefCheckpointManager(str(tmp_path / "ref")).save(2, {"w": jnp.asarray(x, jnp.bfloat16)})
    like = {"w": torch.zeros((3, 5), dtype=torch.bfloat16)}
    got, _, _ = CheckpointManager(str(tmp_path / "ref")).restore(like)
    want = torch.as_tensor(x).to(torch.bfloat16)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], want)
    CheckpointManager(str(tmp_path / "port")).save(2, {"w": want})
    files = [os.path.join(tmp_path, side, "step_0000000002", "w.npy") for side in ("ref", "port")]
    ref_bits, port_bits = (np.load(f).view(np.int16) for f in files)
    assert np.array_equal(ref_bits, port_bits)


def test_port_directory_restores_through_the_reference(tmp_path):
    tree = _tree(4)
    CheckpointManager(str(tmp_path)).save(8, tree, extra={"b": 2.5})
    template = jax.tree.map(lambda x: jnp.zeros_like(jnp.asarray(x.numpy())), tree)
    got, step, extra = RefCheckpointManager(str(tmp_path)).restore(template)
    assert step == 8 and extra == {"b": 2.5}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype


def test_summary_state_leaves_as_the_reference_writes_them(tmp_path):
    """``node2super`` and ``size`` int32 [V], ``t`` an int32 scalar on disk;
    read back as the port's int64 tensors and int."""
    state = SummaryState(node2super=torch.tensor([0, 0, 2, 3, 2, 5, 6]),
                         size=torch.tensor([2, 0, 2, 1, 0, 1, 1]), t=4)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _state_on_disk(state))
    manifest = json.loads((tmp_path / "step_0000000003" / "manifest.json").read_text())
    assert manifest["leaves"] == {
        "node2super": {"file": "node2super.npy", "dtype": "int32", "shape": [7]},
        "size": {"file": "size.npy", "dtype": "int32", "shape": [7]},
        "t": {"file": "t.npy", "dtype": "int32", "shape": []}}
    got, _, _ = mgr.restore(init_state(7, "cpu"))
    assert got.node2super.dtype == torch.int64 and got.size.dtype == torch.int64
    assert torch.equal(got.node2super, state.node2super)
    assert torch.equal(got.size, state.size)
    assert got.t == 4 and type(got.t) is int


# ---------------------------------------------------------------------------
# the permutation sources' positions
# ---------------------------------------------------------------------------


def test_torch_permutations_continue_from_a_saved_position():
    a = TorchPermutations(5, "cpu")
    a.draw(50, torch.device("cpu"))
    sd = json.loads(json.dumps(a.state_dict()))  # as the checkpoint payload holds it
    assert sd["kind"] == "torch" and sd["device_type"] == "cpu"
    want = a.draw(50, torch.device("cpu"))
    b = TorchPermutations(5, "cpu")
    b.load_state_dict(sd)
    got = b.draw(50, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("sd,match", [
    ({"kind": "torch", "device_type": "cuda", "state": [0] * 16}, "cuda"),
    ({"kind": "replay", "used": 1}, "replay"),
])
def test_torch_permutations_refuse_another_state(sd, match):
    with pytest.raises(ValueError, match=match):
        TorchPermutations(0, "cpu").load_state_dict(sd)


def test_replay_permutations_state_is_the_rounds_used():
    rng = np.random.default_rng(0)
    rounds = [(rng.permutation(9), rng.permutation(9)) for _ in range(3)]
    a = ReplayPermutations(rounds)
    a.draw(9, torch.device("cpu"))
    b = ReplayPermutations(rounds)
    b.load_state_dict(a.state_dict())
    assert b.used == 1
    assert all(torch.equal(x, y) for x, y in zip(a.draw(9, "cpu"), b.draw(9, "cpu")))
    with pytest.raises(ValueError):
        b.load_state_dict({"kind": "replay", "used": 4})
    with pytest.raises(ValueError):
        b.load_state_dict(TorchPermutations(0, "cpu").state_dict())


def test_preemption_guard_sets_the_flag_and_restores_the_handlers():
    import signal

    before = signal.getsignal(signal.SIGUSR1)
    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    assert not guard.preempted
    signal.raise_signal(signal.SIGUSR1)  # the first signal only sets the flag
    assert guard.preempted
    guard.restore()
    assert signal.getsignal(signal.SIGUSR1) == before


# ---------------------------------------------------------------------------
# straggler monitor (the cases of tests/test_runtime.py)
# ---------------------------------------------------------------------------


def test_straggler_flags_spike():
    mon = StragglerMonitor(warmup_steps=3, z_threshold=3.0, ratio_threshold=1.5)
    flags = [mon.observe(i, 0.1 + 0.001 * (i % 3)) for i in range(20)]
    assert not any(flags)
    assert mon.observe(20, 1.0)  # a 10x spike
    assert len(mon.events) == 1 and mon.events[0].ratio > 5
    assert mon.mean < 0.2  # the EMA is not polluted by the spike


def test_straggler_callback():
    mon = StragglerMonitor(warmup_steps=2, z_threshold=2.0, ratio_threshold=1.5)
    seen = []
    mon.on_straggler(seen.append)
    for i in range(10):
        mon.observe(i, 0.05)
    mon.observe(10, 0.5)
    assert len(seen) == 1 and seen[0].step == 10


def test_straggler_end_without_begin_raises():
    with pytest.raises(RuntimeError):
        StragglerMonitor().end_step(0)
