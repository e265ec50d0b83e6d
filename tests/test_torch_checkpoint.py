"""Checkpoints in the port, on the CPU: the durability and integrity
contract of the reference's ``CheckpointManager`` (the port's
counterparts of ``tests/test_robustness.py``'s checkpoint tests), one
on-disk format for both packages, bf16 leaves, and
``convert.to_jax_params``.

Across packages every claim is bitwise: the port's manifest and leaf files
are byte for byte the reference's for the same tree, each package restores
what the other wrote (fp32; a legacy checkpoint of separate ``wq``/``wk``/
``wv`` leaves is packed into ``wqkv``), and a checkpoint the reference
wrote serves through ``ServeEngine.from_checkpoint`` the logits of the
port model loaded by ``convert.from_jax_params``.  The port writes a bf16
leaf as the reference does (descr ``'<V2'``, dtype ``"bfloat16"``) and
restores it; the reference refuses it (ROADMAP F7), which a test pins.
"""
import dataclasses
import filecmp
import json
import os
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jax_config
from repro.launch.mesh import make_mesh
from repro.models.lm import Model as JaxModel

import repro_torch.checkpoint.manager as cm
from repro_torch.checkpoint import CheckpointCorruptionError, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.models.lm import Model
from repro_torch.robust import bitflip_leaf, truncate_leaf, truncate_manifest
from repro_torch.serve.engine import ServeConfig, ServeEngine

# the CPU's cores go to the test workers, not to one worker's torch pool
torch.set_num_threads(1)

ARCH = "internlm2-1.8b"
FAMILIES = ["internlm2-1.8b", "gemma2-27b", "gemma3-12b", "whisper-small",
            "llama4-scout-17b-a16e"]


def _tree():
    return {"w": {"a": np.arange(16, dtype=np.float32).reshape(4, 4),
                  "b": np.ones((3,), np.float32)}}


def _fail_second_leaf(monkeypatch):
    real = cm._write_leaf
    calls = {"n": 0}

    def flaky(path, arr):
        calls["n"] += 1
        if calls["n"] == 2:
            raise OSError("disk full mid-leaf (injected)")
        real(path, arr)
    monkeypatch.setattr(cm, "_write_leaf", flaky)


@pytest.fixture(scope="module")
def ref():
    """The reference's smoke model and its ``init_params(0)`` as numpy."""
    jm = JaxModel(dataclasses.replace(jax_config(ARCH, smoke=True),
                                      compute_dtype="float32"),
                  make_mesh(1, 1))
    return jm, jax.tree.map(np.asarray, jm.init_params(0))


def _port_model(params, cfg=None):
    cfg = cfg or dataclasses.replace(get_config(ARCH, smoke=True),
                                     compute_dtype="float32")
    tm = Model(cfg, device="cpu")
    tm.load_state_dict(from_jax_params(cfg, params))
    return tm


def _step_dir(d, step):
    return os.path.join(str(d), f"step_{step:08d}")


# ---------------------------------------------------------------------------
# durability: writer failures surface at sync points, GC spares in-flight
# ---------------------------------------------------------------------------

def test_async_writer_failure_reraised_at_wait(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    _fail_second_leaf(monkeypatch)
    mgr.save(1, _tree())
    with pytest.raises(OSError, match="disk full mid-leaf"):
        mgr.wait()
    mgr.wait()                          # raised once, then cleared
    assert mgr.all_steps() == []
    monkeypatch.undo()
    mgr.save(2, _tree())
    mgr.wait()
    assert mgr.all_steps() == [2]


def test_async_writer_failure_reraised_at_next_save(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    _fail_second_leaf(monkeypatch)
    mgr.save(1, _tree())
    mgr._thread.join()                  # join alone never raises
    monkeypatch.undo()
    with pytest.raises(OSError, match="disk full mid-leaf"):
        mgr.save(2, _tree())
    mgr.save(2, _tree())
    mgr.wait()
    assert mgr.all_steps() == [2]


def test_blocking_save_failure_raises_inline(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    _fail_second_leaf(monkeypatch)
    with pytest.raises(OSError, match="disk full mid-leaf"):
        mgr.save(1, _tree(), blocking=True)
    assert not os.path.exists(_step_dir(tmp_path, 1) + ".tmp")


def test_gc_never_deletes_inflight_step(tmp_path, monkeypatch):
    committed, release = threading.Event(), threading.Event()
    real_rename = os.rename

    def slow_rename(src, dst):
        real_rename(src, dst)
        if dst.endswith("step_00000001"):
            committed.set()
            assert release.wait(10)
    monkeypatch.setattr(cm.os, "rename", slow_rename)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, _tree())                # the writer parks past its commit
    assert committed.wait(10)
    other = CheckpointManager(str(tmp_path), keep=10)
    other.save(2, _tree(), blocking=True)
    other.save(3, _tree(), blocking=True)
    mgr._gc()           # keep=1 would take steps 1 and 2, but 1 is pending
    assert 1 in mgr.all_steps() and 2 not in mgr.all_steps()
    release.set()
    mgr.wait()          # the writer retires step 1, then runs its own gc
    assert mgr.all_steps() == [3]


def test_async_save_copies_on_the_callers_thread(tmp_path):
    """The writer serializes host copies taken when ``save`` was called:
    a tensor changed after ``save`` returns is written as it was."""
    t = torch.arange(8, dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"t": t, "b": t.to(torch.bfloat16)})
    t.add_(100.0)
    mgr.wait()
    _, got = mgr.restore(1)
    np.testing.assert_array_equal(got["t"], np.arange(8, dtype=np.float32))
    np.testing.assert_array_equal(
        got["b"].view(np.int16),
        torch.arange(8, dtype=torch.bfloat16).view(torch.int16).numpy())


# ---------------------------------------------------------------------------
# integrity: structured corruption errors, fallback to an intact step
# ---------------------------------------------------------------------------

def test_truncated_leaf_is_structured_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    name = truncate_leaf(str(tmp_path), 1, leaf=0)
    with pytest.raises(CheckpointCorruptionError) as ei:
        mgr.restore(1, _tree())
    assert ei.value.param == name == "['w']['a']" and name in str(ei.value)
    assert ei.value.step == 1 and "unreadable leaf file" in ei.value.reason


def test_bitflipped_leaf_caught_by_checksum(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    name = bitflip_leaf(str(tmp_path), 1, leaf=1, seed=7)
    with pytest.raises(CheckpointCorruptionError) as ei:
        mgr.restore(1, _tree())
    assert ei.value.param == name and "crc32 mismatch" in ei.value.reason


def test_restore_names_the_first_corrupted_leaf_in_order(tmp_path,
                                                         monkeypatch):
    """Leaves are read on IO_THREADS threads at once: of two corrupted
    leaves the error names the first in flatten order, although the other
    leaf's read fails first."""
    monkeypatch.setattr(cm, "IO_THREADS", 2)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    bitflip_leaf(str(tmp_path), 1, leaf=1, seed=7)
    name = truncate_leaf(str(tmp_path), 1, leaf=0)
    real = CheckpointManager._load_leaf

    def slow_first(self, d, meta, step):
        if meta["file"] == "arr_0.npy":
            time.sleep(0.2)
        return real(self, d, meta, step)
    monkeypatch.setattr(CheckpointManager, "_load_leaf", slow_first)
    with pytest.raises(CheckpointCorruptionError) as ei:
        mgr.restore(1, _tree())
    assert ei.value.param == name == "['w']['a']"
    assert "unreadable leaf file" in ei.value.reason


def test_truncated_manifest_is_structured_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    truncate_manifest(str(tmp_path), 1)
    with pytest.raises(CheckpointCorruptionError) as ei:
        mgr.restore(1, _tree())
    assert ei.value.param == "manifest.json"


def test_fallback_restores_newest_earlier_intact_step(tmp_path, capsys):
    mgr = CheckpointManager(str(tmp_path))
    t1, t2 = _tree(), _tree()
    t2["w"]["a"] = t2["w"]["a"] + 100.0
    mgr.save(1, t1, blocking=True)
    mgr.save(2, t2, blocking=True)
    bitflip_leaf(str(tmp_path), 2, leaf=0)
    step, got = mgr.restore(None, t1, fallback=True)
    assert step == 1
    np.testing.assert_array_equal(got["w"]["a"], t1["w"]["a"])
    assert "falling back" in capsys.readouterr().out
    with pytest.raises(CheckpointCorruptionError):
        mgr.restore(2, t1)


def test_fallback_exhausted_names_the_dead_end(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree(), blocking=True)
    name = truncate_leaf(str(tmp_path), 1)
    with pytest.raises(CheckpointCorruptionError,
                       match="no earlier intact step") as ei:
        mgr.restore(1, _tree(), fallback=True)
    assert ei.value.param == name


def test_serve_engine_falls_back_to_previous_intact_step(ref, tmp_path,
                                                         capsys):
    """A restart pointed at a corrupted newest step serves the previous
    intact one, and says so; without fallback it stops on the bad step."""
    _, params = ref
    cfg = _port_model(params).cfg
    bumped = jax.tree.map(lambda x: x * np.float32(1.01), params)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, params, blocking=True)
    mgr.save(2, bumped, blocking=True)
    name = bitflip_leaf(str(tmp_path), 2, leaf=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        scfg = ServeConfig(max_new_tokens=4)
    eng = ServeEngine.from_checkpoint(Model(cfg, device="cpu"),
                                      str(tmp_path), scfg=scfg)
    out = capsys.readouterr().out
    assert "falling back" in out and name in out
    batch = {"tokens": torch.arange(32).reshape(2, 16)}
    want = ServeEngine(_port_model(params), scfg).generate(batch)
    np.testing.assert_array_equal(eng.generate(batch), want)
    with pytest.raises(CheckpointCorruptionError):
        ServeEngine.from_checkpoint(Model(cfg, device="cpu"), str(tmp_path),
                                    step=2, scfg=scfg, fallback=False)


# ---------------------------------------------------------------------------
# one format for both packages
# ---------------------------------------------------------------------------

def _same_files(a, b, step=1):
    da, db = _step_dir(a, step), _step_dir(b, step)
    with open(os.path.join(da, "manifest.json")) as f:
        ma = json.load(f)
    with open(os.path.join(db, "manifest.json")) as f:
        mb = json.load(f)
    assert ma == mb
    for leaf in ma["leaves"]:
        assert filecmp.cmp(os.path.join(da, leaf["file"]),
                           os.path.join(db, leaf["file"]), shallow=False)


def test_port_checkpoint_restores_in_reference(ref, tmp_path):
    """The port writes the reference's bytes (manifest and leaves) for the
    model's own weights, and the reference restores them bitwise."""
    _, params = ref
    tm = _port_model(params)
    CheckpointManager(str(tmp_path / "port")).save(
        3, to_jax_params(tm.cfg, tm.state_dict()), blocking=True)
    JCheckpointManager(str(tmp_path / "ref")).save(3, params, blocking=True)
    _same_files(tmp_path / "port", tmp_path / "ref", step=3)
    step, got = JCheckpointManager(str(tmp_path / "port")).restore(3, params)
    assert step == 3
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_reference_checkpoint_serves_in_port(ref, tmp_path):
    """``from_checkpoint`` of a checkpoint the reference wrote: the logits
    bitwise those of the port model loaded by ``from_jax_params``, and
    with ``int8`` the one-shot quantization of the restored weights."""
    jm, params = ref
    JCheckpointManager(str(tmp_path)).save(5, jax.tree.map(
        jnp.asarray, params), blocking=True)
    want = _port_model(params)
    eng = ServeEngine.from_checkpoint(Model(want.cfg, device="cpu"),
                                      str(tmp_path))
    toks = torch.arange(24).reshape(2, 12) % want.cfg.vocab
    got_logits, _ = eng.model.prefill(toks)
    want_logits, _ = want.prefill(toks)
    assert torch.equal(got_logits, want_logits)
    e8 = ServeEngine.from_checkpoint(Model(want.cfg, device="cpu"),
                                     str(tmp_path),
                                     scfg=ServeConfig(int8=True))
    assert e8.model.int8
    w8 = ServeEngine(want, ServeConfig(int8=True))
    assert torch.equal(e8.model.prefill(toks)[0], w8.model.prefill(toks)[0])


def test_reference_legacy_checkpoint_packs_in_port(ref, tmp_path):
    """A reference ``export_legacy`` checkpoint (separate wq/wk/wv leaves)
    restores in the port with ``wqkv`` packed bitwise; the port's own
    export writes the reference's bytes."""
    jm, params = ref
    JCheckpointManager(str(tmp_path / "ref")).export_legacy(
        1, params, jm.param_defs())
    cfg = _port_model(params).cfg
    _, got = CheckpointManager(str(tmp_path / "ref")).restore(1, cfg=cfg)
    w = params["groups"]["b0"]["attn"]["wqkv"]
    np.testing.assert_array_equal(got["groups"]["b0"]["attn"]["wqkv"], w)
    assert set(got["groups"]["b0"]["attn"]) == {"wqkv", "wo"}
    with pytest.raises(ValueError, match="cfg="):
        CheckpointManager(str(tmp_path / "ref")).restore(1, params)
    CheckpointManager(str(tmp_path / "port")).export_legacy(1, params, cfg)
    _same_files(tmp_path / "port", tmp_path / "ref")


# ---------------------------------------------------------------------------
# bf16 leaves
# ---------------------------------------------------------------------------

def test_bf16_round_trip_bitwise(ref, tmp_path):
    """bf16 weights (a bf16 copy of the smoke model) written by the port
    restore bitwise through ``from_checkpoint``; the files are the bytes
    the reference writes for the same bf16 tree, which the port also
    restores."""
    _, params = ref
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              param_dtype="bfloat16")
    tm = _port_model(params, cfg)
    sd = tm.state_dict()
    assert sd["embed"].dtype == torch.bfloat16
    CheckpointManager(str(tmp_path / "port")).save(
        1, to_jax_params(cfg, sd), blocking=True)
    eng = ServeEngine.from_checkpoint(Model(cfg, device="cpu"),
                                      str(tmp_path / "port"))
    for k, v in eng.model.state_dict().items():
        assert v.dtype == sd[k].dtype and torch.equal(v, sd[k]), k
    norms = ("['ln1']", "['ln2']", "['final_norm']")
    jtree = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(x).astype(
            jnp.float32 if jax.tree_util.keystr(path).endswith(norms)
            else jnp.bfloat16), params)
    JCheckpointManager(str(tmp_path / "ref")).save(1, jtree, blocking=True)
    _same_files(tmp_path / "port", tmp_path / "ref")
    _, back = CheckpointManager(str(tmp_path / "ref")).restore(1)
    got = from_jax_params(cfg, back)
    assert all(torch.equal(got[k].to(v.dtype), v) for k, v in sd.items())


def test_reference_refuses_bf16_checkpoints(tmp_path):
    """ROADMAP F7: the reference cannot restore a bf16 leaf, its own or the
    port's (the loaded dtype is ``V2``, the manifest's ``bfloat16``).  If
    the installed numpy or jax changes that, this test says so."""
    like = {"a": jnp.zeros((2, 3), jnp.bfloat16)}
    JCheckpointManager(str(tmp_path / "ref")).save(1, like, blocking=True)
    CheckpointManager(str(tmp_path / "port")).save(
        1, {"a": torch.zeros((2, 3), dtype=torch.bfloat16)}, blocking=True)
    for d in ("ref", "port"):
        with pytest.raises(Exception, match=r"bfloat16, file holds.*V2"):
            JCheckpointManager(str(tmp_path / d)).restore(1, like)
        _, got = CheckpointManager(str(tmp_path / d)).restore(1)
        assert got["a"].dtype == cm.BF16_WORDS


@pytest.mark.parametrize("arch", FAMILIES)
def test_to_jax_params_inverts_from_jax_params(arch):
    jm = JaxModel(jax_config(arch, smoke=True), make_mesh(1, 1))
    params = jax.tree.map(np.asarray, jm.init_params(0))
    cfg = get_config(arch, smoke=True)
    back = to_jax_params(cfg, from_jax_params(cfg, params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = cm.flatten(back)
    assert [p for p, _ in got] == [jax.tree_util.keystr(k) for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
