"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
package's format, on the CPU, with no ranks.

- the codec (``checkpoint.codec``) against ``msgpack``: what it writes
  ``msgpack.unpackb`` reads back, and it reads what ``msgpack.packb`` writes
  for every type the checkpoint files use; malformed input raises;
- the format's contract, as ``tests/test_fault.py`` pins JAX's: structural
  mismatches raise ValueError naming the leaf, damage raises
  ``CheckpointCorruptionError``, ``restore_latest_valid`` falls back and
  refuses an all-corrupt directory, retention and the orphan sweep,
  background saves equal sync ones, v1 files restore, bf16 round-trips, a
  leaf over bin32's limit is refused;
- both ways across the packages: a reduced Llama and a reduced BigLSTM
  ``TrainState`` after one AdamW step (carried across with
  ``repro_torch.interop``) saved by the port restore bit-equal through
  ``repro.checkpoint.restore_checkpoint`` into JAX's ``eval_train_state``,
  and JAX's v2 and hand-written v1 files restore bit-equal through the
  port; the port's ``eval_train_state`` has JAX's leaves, dtypes and shapes
  in JAX's order, with no storage.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro_torch import checkpoint as C
from repro_torch.checkpoint import codec
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.api import build_model as t_build_model
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import constant_lr as t_constant_lr
from repro_torch.train.fault import corrupt_checkpoint
from repro_torch.train.steps import TrainState, eval_train_state, make_train_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _tiny_state(step=4):
    return TrainState(params={"w": torch.arange(6.0).reshape(2, 3),
                              "b": torch.ones(3, dtype=torch.int32)},
                      opt_state={"m": {"w": torch.zeros(2, 3)}}, step=step)


def _like(state):
    return dataclasses.replace(state, params={k: torch.empty_like(v, device="meta")
                                              for k, v in state.params.items()})


def _leaves(state):
    return C._leaves(state)


def _raw(fname):
    return msgpack.unpackb(open(fname, "rb").read(), raw=False)


# -- the codec ---------------------------------------------------------------

PACKED = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32, -33,
          -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63, "", "a" * 31, "b" * 32,
          "c" * 255, "d" * 256, "e" * 65536, "ünï", b"", b"\x00" * 300, [], [1, [2, "x"]],
          {}, {"k": {"n": [1, 2]}}, {str(i): i for i in range(17)}]


@pytest.mark.parametrize("obj", PACKED, ids=lambda o: f"{type(o).__name__}{len(str(o))}")
def test_codec_writes_what_msgpack_reads(obj):
    assert msgpack.unpackb(codec.pack(obj), raw=False, strict_map_key=False) == obj


def _plain(x):
    if isinstance(x, memoryview):
        return bytes(x)
    if isinstance(x, list):
        return [_plain(y) for y in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


READ = PACKED + [None, True, False, 1.5, float(np.float32(0.1)), b"\x01" * 70000,
                 list(range(16)), list(range(70000)), {i: i for i in range(16)},
                 {i: [i] for i in range(70000)}, [None, True, {"a": b"z"}]]


@pytest.mark.parametrize("obj", READ, ids=lambda o: f"{type(o).__name__}{len(str(o))}")
def test_codec_reads_what_msgpack_writes(obj):
    assert _plain(codec.unpack(msgpack.packb(obj, use_bin_type=True))) == obj


def test_codec_reads_float32_and_refuses_malformed_input():
    assert codec.unpack(b"\xca" + np.float32(0.5).byteswap().tobytes()) == 0.5
    for bad in (b"", b"\xc6\x00\x00\x00\x09abc", b"\x92\x01", b"\x01\x02", b"\xc1",
                b"\xa2\xff\xfe", b"\xdd\xff\xff\xff\xff", b"\x81\x90\x01"):
        with pytest.raises(codec.DecodeError):
            codec.unpack(bad)
    with pytest.raises(ValueError, match="bin32"):
        codec.bin_header(2**32)
    with pytest.raises(TypeError):
        codec.pack(1.5)


# -- the format's contract ---------------------------------------------------

def test_restore_leaf_count_mismatch_raises_value_error(tmp_path):
    state = _tiny_state()
    f = C.save_checkpoint(str(tmp_path), state, 4)
    like = _like(state)
    with pytest.raises(ValueError, match="4 leaves.*3 — .*different"):
        C.restore_checkpoint(f, {"params": like.params,
                                 "step": torch.zeros((), dtype=torch.int32)})


def test_restore_validates_per_leaf_dtype_and_shape(tmp_path):
    state = _tiny_state()
    f = C.save_checkpoint(str(tmp_path), state, 4)
    like = _like(state)
    wrong_dtype = dataclasses.replace(like, params=dict(like.params, b=torch.zeros(3)))
    with pytest.raises(ValueError, match=r"params/b.*int32\[3\].*expects float32"):
        C.restore_checkpoint(f, wrong_dtype)
    wrong_shape = dataclasses.replace(like, params=dict(like.params, w=torch.zeros(3, 2)))
    with pytest.raises(ValueError, match=r"params/w.*\[2, 3\].*\[3, 2\]"):
        C.restore_checkpoint(f, wrong_shape)


def test_crc_detects_bitflip_and_fallback_restores_previous(tmp_path):
    state = _tiny_state()
    f1 = C.save_checkpoint(str(tmp_path), state, 1)
    f2 = C.save_checkpoint(str(tmp_path), dataclasses.replace(state, step=2), 2)
    corrupt_checkpoint(f2, "bitflip")
    like = _like(state)
    with pytest.raises(C.CheckpointCorruptionError):
        C.restore_checkpoint(f2, like)
    with pytest.warns(UserWarning, match="skipping ckpt_00000002"):
        restored, fname = C.restore_latest_valid(str(tmp_path), like)
    assert fname == f1 and restored.step == 4
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_a_flipped_byte_anywhere_in_the_leaves_fails_the_crc(tmp_path, seed):
    """A real state's file is mostly leaf bytes: a flip there is a CRC
    mismatch, as JAX's files detect it."""
    gen = torch.Generator().manual_seed(seed)
    state = TrainState({"w": torch.randn(64, 64, generator=gen)}, {}, 1)
    f = C.save_checkpoint(str(tmp_path), state)
    size = os.path.getsize(f)
    off = int(torch.randint(size // 8, size // 2, (1,), generator=gen))
    data = bytearray(open(f, "rb").read())
    data[off] ^= 0x10
    open(f, "wb").write(bytes(data))
    with pytest.raises(C.CheckpointCorruptionError, match="CRC32 mismatch"):
        C.verify_checkpoint(f)


def test_truncation_detected(tmp_path):
    f = C.save_checkpoint(str(tmp_path), _tiny_state(), 1)
    corrupt_checkpoint(f, "truncate")
    with pytest.raises(C.CheckpointCorruptionError):
        C.verify_checkpoint(f)
    open(f, "wb").close()
    with pytest.raises(C.CheckpointCorruptionError, match="empty"):
        C.verify_checkpoint(f)


def test_all_corrupt_directory_raises_not_fresh_init(tmp_path):
    state = _tiny_state()
    for step in (1, 2):
        corrupt_checkpoint(C.save_checkpoint(str(tmp_path), state, step), "truncate")
    with pytest.warns(UserWarning, match="skipping"):
        with pytest.raises(C.CheckpointCorruptionError, match=r"all 2 checkpoint\(s\).*failed"):
            C.restore_latest_valid(str(tmp_path), _like(state))
    empty = tmp_path / "empty"
    empty.mkdir()
    assert C.restore_latest_valid(str(empty), _like(state)) == (None, None)


def test_verify_checkpoint_reports_manifest(tmp_path):
    state = _tiny_state()
    f = C.save_checkpoint(str(tmp_path), state, 7)
    info = C.verify_checkpoint(f)
    assert info == {"step": 7, "n_leaves": 4, "bytes": 24 + 12 + 24 + 4, "version": 2}
    assert C.checkpoint_step(f) == 7 and C.latest_checkpoint(str(tmp_path)) == f
    with pytest.raises(ValueError, match="not a checkpoint"):
        C.checkpoint_step("model.bin")


def test_keep_last_retention_and_orphan_tmp_cleanup(tmp_path):
    state = _tiny_state()
    orphan = tmp_path / "ckpt_00000001.msgpack.tmp-9999"
    orphan.write_bytes(b"half-written garbage from a dead process")
    for s in range(1, 6):
        C.save_checkpoint(str(tmp_path), state, s, keep_last=2)
    names = [os.path.basename(p) for p in C.list_checkpoints(str(tmp_path))]
    assert names == ["ckpt_00000004.msgpack", "ckpt_00000005.msgpack"]
    assert not orphan.exists()
    assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]


def test_background_save_is_bit_equal_to_sync_and_snapshots_the_state(tmp_path):
    state = _tiny_state()
    f_sync = C.save_checkpoint(str(tmp_path / "a"), state, 3)
    f_bg = C.save_checkpoint(str(tmp_path / "b"), state, 3, background=True)
    state.params["w"].add_(1.0)         # the next step's in-place update
    C.wait_for_saves()
    assert open(f_sync, "rb").read() == open(f_bg, "rb").read()
    C.verify_checkpoint(f_bg)


def test_background_failure_surfaces_in_wait_for_saves(tmp_path, monkeypatch):
    def disk_full(*args):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(C, "_write", disk_full)
    C.save_checkpoint(str(tmp_path), _tiny_state(), 1, background=True)
    with pytest.raises(C.CheckpointError, match="background") as err:
        C.wait_for_saves()
    assert isinstance(err.value.__cause__, OSError)
    C.wait_for_saves()                  # the error is reported once
    assert not C.list_checkpoints(str(tmp_path))


def test_timings_and_the_file_layout(tmp_path):
    """The writer streams ``version``, ``step``, ``treedef``, ``leaves``, then
    ``manifest``; ``timings`` splits a sync save."""
    timings = {}
    f = C.save_checkpoint(str(tmp_path), _tiny_state(), 4, timings=timings)
    assert set(timings) == {"host_s", "write_s", "fsync_s"}
    raw = _raw(f)
    assert list(raw) == ["version", "step", "treedef", "leaves", "manifest"]
    assert raw["treedef"] == ("TrainState(params={'b': *, 'w': *}, opt_state={'m': "
                              "{'w': *}}, step=*)")
    assert raw["manifest"][-1]["dtype"] == "int32" and raw["manifest"][-1]["shape"] == []


def test_legacy_v1_checkpoint_still_restores(tmp_path):
    state = _tiny_state()
    v1 = {"treedef": "x", "leaves": [{"dtype": C._NAMES[t.dtype], "shape": list(t.shape),
                                      "data": t.numpy().tobytes()} for t in _leaves(state)]}
    f = str(tmp_path / "ckpt_00000004.msgpack")
    with open(f, "wb") as fh:
        fh.write(msgpack.packb(v1, use_bin_type=True))
    restored = C.restore_checkpoint(f, _like(state))
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert torch.equal(a, b)
    assert C.verify_checkpoint(f)["version"] == 1


def test_bf16_leaf_round_trips(tmp_path):
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(3)).bfloat16()
    f = C.save_checkpoint(str(tmp_path), {"x": x, "s": torch.ones((), dtype=torch.bool)}, 1)
    got = C.restore_checkpoint(f, {"x": torch.empty(5, 7, dtype=torch.bfloat16, device="meta"),
                                   "s": torch.empty((), dtype=torch.bool, device="meta")})
    assert got["x"].dtype == torch.bfloat16 and torch.equal(got["x"], x)
    assert got["s"].dtype == torch.bool and bool(got["s"])
    raw = _raw(f)
    entry = raw["manifest"][raw["manifest"][0]["dtype"] != "bfloat16"]
    assert entry["dtype"] == "bfloat16"
    as_ml = np.frombuffer(raw["leaves"][1], ml_dtypes.bfloat16).reshape(5, 7)
    np.testing.assert_array_equal(as_ml.astype(np.float32), x.float().numpy())


def test_a_leaf_past_bin32_is_refused_before_any_write(tmp_path):
    big = {"embed": torch.empty(2**30 + 1, dtype=torch.float32, device="meta")}
    with pytest.raises(ValueError, match="leaf embed .*bin32"):
        C.save_checkpoint(str(tmp_path), big, 1)
    assert not os.listdir(tmp_path)


# -- across the packages -----------------------------------------------------

def _jax_side(arch):
    from repro.configs import get_config as j_get_config
    from repro.models.api import build_model as j_build_model
    from repro.optim import adamw as j_adamw
    from repro.optim import constant_lr as j_constant_lr
    from repro.train.steps import eval_train_state as j_eval_train_state

    japi = j_build_model(j_get_config(arch).reduced(), remat=False)
    jopt = j_adamw(j_constant_lr(3e-3))
    return japi, jopt, j_eval_train_state(japi, jopt)


def _port_state_after_one_step(arch):
    """A reduced ``arch`` TrainState one AdamW step from the JAX init."""
    from repro_torch.interop import params_from_jax

    japi, jopt, jlike = _jax_side(arch)
    cfg = t_get_config(arch).reduced()
    api = t_build_model(cfg, device="cpu")
    opt = t_adamw(t_constant_lr(3e-3))
    params = params_from_jax(jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0))),
                             cfg, "cpu")
    state = TrainState(params=params, opt_state=opt.init(params), step=0)
    tokens = torch.randint(0, 64, (2, 9), generator=torch.Generator().manual_seed(1))
    state, _ = make_train_step(api, opt)(state, {"tokens": tokens[:, :-1],
                                                  "labels": tokens[:, 1:]})
    return api, opt, state, jlike


@pytest.mark.parametrize("arch", ["llama3_2_1b", "biglstm"])
def test_port_file_restores_bit_equal_through_jax(arch, tmp_path):
    from repro.checkpoint import restore_checkpoint as j_restore

    _, _, state, jlike = _port_state_after_one_step(arch)
    f = C.save_checkpoint(str(tmp_path), state)
    restored = j_restore(f, jlike)
    jleaves = jax.tree.leaves(restored)
    ours = _leaves(state)
    assert len(jleaves) == len(ours) and int(restored.step) == 1
    for a, b in zip(ours, jleaves):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    raw = _raw(f)
    assert raw["version"] == 2 and raw["step"] == 1 and len(raw["leaves"]) == len(ours)


@pytest.mark.parametrize("arch", ["llama3_2_1b", "biglstm"])
def test_jax_files_restore_bit_equal_through_the_port(arch, tmp_path):
    from repro.checkpoint import save_checkpoint as j_save
    from repro.train.steps import TrainState as JTrainState

    japi, jopt, _ = _jax_side(arch)
    jparams = japi.init(jax.random.PRNGKey(0))
    jstate = JTrainState(params=jparams, opt_state=jopt.init(jparams),
                         step=jnp.asarray(3, jnp.int32))
    jstate = dataclasses.replace(jstate, opt_state=jax.tree.map(lambda x: x + 0.5,
                                                                jstate.opt_state))
    cfg = t_get_config(arch).reduced()
    like = eval_train_state(t_build_model(cfg, device="cpu"), t_adamw(t_constant_lr(3e-3)))
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    f2 = j_save(str(tmp_path / "v2"), jstate)
    v1 = {"treedef": "jax", "leaves": [{"dtype": str(x.dtype), "shape": list(x.shape),
                                        "data": x.tobytes()} for x in jleaves]}
    f1 = str(tmp_path / "ckpt_00000003.msgpack")
    with open(f1, "wb") as fh:
        fh.write(msgpack.packb(v1, use_bin_type=True))
    for f in (f2, f1):
        restored = C.restore_checkpoint(f, like)
        assert restored.step == 3
        ours = _leaves(restored)
        assert len(ours) == len(jleaves)
        for a, b in zip(ours, jleaves):
            assert a.numpy().tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", ["llama3_2_1b", "smollm_360m", "biglstm", "gnmt",
                                  "inception_v3", "granite_moe_1b_a400m", "rwkv6_7b"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_eval_train_state_is_jaxs_like_tree(arch, reduced):
    """Leaf for leaf in the files' order: JAX's dtype and shape, no storage."""
    from repro.configs import get_config as j_get_config
    from repro.models.api import build_model as j_build_model
    from repro.optim import adamw as j_adamw
    from repro.optim import constant_lr as j_constant_lr
    from repro.train.steps import eval_train_state as j_eval_train_state

    jcfg, cfg = j_get_config(arch), t_get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jlike = j_eval_train_state(j_build_model(jcfg, remat=False), j_adamw(j_constant_lr(1e-3)))
    like = eval_train_state(t_build_model(cfg, device="cpu"), t_adamw(t_constant_lr(1e-3)))
    ours = C._leaves(like)
    theirs = jax.tree.leaves(jlike)
    assert len(ours) == len(theirs)
    for path, t, j in zip(C._paths(like), ours, theirs):
        assert C._spec(t) == (str(j.dtype), tuple(j.shape)), path
    assert all(t.device.type == "meta" for t in ours[:-1])
