"""The port's checkpoints (checkpointing/checkpoint.py: its own msgpack
codec, no ``msgpack`` or ``ml_dtypes``) against the JAX package's.

* the codec: ``packb`` of ints at every width boundary, floats, str /
  bin / arrays / maps at every header size, nil and bools equals
  ``msgpack.packb(obj, use_bin_type=True)`` BYTE FOR BYTE, and
  ``unpackb`` of those bytes equals ``msgpack.unpackb``;
* a nested tree (float32, int32, uint32, int64 and float64 arrays, numpy
  scalars, bfloat16, tuples, lists, None) packs to the reference's bytes;
* the reference's ``load`` reads a file the port wrote, and the port's
  ``load`` reads the reference's, leaf for leaf bitwise (bfloat16
  through torch's own dtype);
* saves replace the file atomically and leave no temporary behind;
  unsupported leaves and truncated files raise.
"""
import os

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpointing import checkpoint as jckpt
from repro_torch.checkpointing import checkpoint as ckpt

VALUES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
          2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
          -2 ** 31 - 1, -2 ** 63, 1.5, -0.0, float("inf"), 1e-300,
          True, False, None, "", "é", "a" * 31, "a" * 32, "a" * 255,
          "a" * 256, "a" * 65536, b"", b"x" * 255, b"x" * 256,
          b"x" * 65536, [], list(range(15)), list(range(16)),
          list(range(65536)), {}, {f"k{i}": i for i in range(15)},
          {f"k{i}": i for i in range(16)},
          {"nested": [1, {"b": None, "c": [b"\x00", 2.5]}]}]


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_codec_bytes_equal_msgpack(i):
    v = VALUES[i]
    want = msgpack.packb(v, use_bin_type=True)
    assert ckpt.packb(v) == want
    assert ckpt.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_rejects_what_it_cannot_hold():
    with pytest.raises(TypeError):
        ckpt.packb({1.5})
    with pytest.raises(OverflowError):
        ckpt.packb(2 ** 64)
    with pytest.raises(ValueError, match="truncated"):
        ckpt.unpackb(msgpack.packb("abcdef")[:-2])
    with pytest.raises(ValueError, match="trailing"):
        ckpt.unpackb(msgpack.packb(1) + b"\x01")


def _tree(bf16):
    rng = np.random.default_rng(0)
    return {
        "w": rng.normal(size=(3, 5)).astype(np.float32),
        "step": np.int32(7),
        "key": np.array([0, 4294967295], np.uint32),
        "orders": np.arange(5, dtype=np.int64),
        "rdp": rng.random(5),
        "bf": bf16,
        "pair": (1, 2.5, "q"),
        "list": [np.float32(3.0), None, {"x": True}],
        "none": None,
    }


def test_tree_packs_to_the_reference_bytes():
    vals = np.random.default_rng(1).normal(size=(2, 3)).astype(np.float32)
    jtree = _tree(jnp.asarray(vals, jnp.bfloat16))
    ttree = _tree(torch.from_numpy(vals).to(torch.bfloat16))
    assert ckpt.packb(ckpt._pack(ttree)) == \
        msgpack.packb(jckpt._pack(jtree), use_bin_type=True)


def test_files_cross_read(tmp_path):
    vals = np.random.default_rng(2).normal(size=(4,)).astype(np.float32)
    ttree = _tree(torch.from_numpy(vals).to(torch.bfloat16))
    jtree = _tree(jnp.asarray(vals, jnp.bfloat16))
    mine, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "j.msgpack")
    ckpt.save(mine, ttree)
    jckpt.save(theirs, jtree)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    back = jckpt.load(mine)                    # the reference reads ours
    got = ckpt.load(theirs)                    # we read the reference's
    for k in ("w", "step", "key", "orders", "rdp"):
        np.testing.assert_array_equal(np.asarray(back[k]), ttree[k])
        assert isinstance(got[k], np.ndarray)
        assert got[k].dtype == np.asarray(jtree[k]).dtype
        np.testing.assert_array_equal(got[k], np.asarray(jtree[k]))
    assert got["bf"].dtype == torch.bfloat16
    assert torch.equal(got["bf"], ttree["bf"])
    np.testing.assert_array_equal(np.asarray(back["bf"], np.float32),
                                  ttree["bf"].float().numpy())
    assert got["pair"] == (1, 2.5, "q") and got["none"] is None
    assert got["list"][1] is None and got["list"][2] == {"x": True}


def test_save_is_atomic_and_leaves_no_temporary(tmp_path):
    path = str(tmp_path / "ck.msgpack")
    ckpt.save(path, {"a": np.ones(3, np.float32)})
    ckpt.save(path, {"a": np.zeros(3, np.float32)})
    assert os.listdir(tmp_path) == ["ck.msgpack"]
    np.testing.assert_array_equal(ckpt.load(path)["a"], np.zeros(3))
    with pytest.raises(TypeError, match="unsupported checkpoint leaf"):
        ckpt.save(str(tmp_path / "bad.msgpack"), {"a": object()})
    assert os.listdir(tmp_path) == ["ck.msgpack"]
