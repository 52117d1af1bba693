"""The port's msgpack codec (``ops/msgpack.py``) against flax's
``msgpack_serialize`` / ``msgpack_restore``: the same trees, the same
bytes. Exact throughout: a codec either reproduces a value or it does
not."""

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedpytorch_tpu_torch.ops import msgpack


def _tree():
    """f32, bf16 and int32 arrays, nested maps, None, bools, ints of
    every width, floats, strings, bytes, numpy scalars, an empty map and
    an empty array, long maps and lists."""
    rng = np.random.default_rng(0)
    return {
        "params": {
            "conv": {"kernel": rng.random((3, 3, 4, 8), dtype=np.float32),
                     "bias": np.zeros((8,), np.float32)},
            "bf16": np.asarray(rng.random((5, 2)), jnp.bfloat16),
        },
        "count": np.asarray(7, np.int32),
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1,
                 -1, -32, -33, -128, -129, -2**15 - 1, -2**40],
        "none": None, "yes": True, "no": False,
        "lr": 1e-4, "inf": float("inf"),
        "name": "héllo" * 10, "blob": b"\x00\x01\x02",
        "scalar_f32": np.float32(2.5), "scalar_i64": np.int64(-3),
        "empty": {}, "zero_rows": np.zeros((0, 3), np.float32),
        "wide": {str(i): i for i in range(20)},
        "rows": [[float(i), i * 0.5] for i in range(40)],
        "u8": np.arange(4, dtype=np.uint8),
        "f64": np.linspace(0, 1, 3),
    }


def _same(port, ref, path="") -> None:
    """``port`` (the codec's decode) holds ``ref`` (flax's) exactly:
    tensors against numpy arrays and scalars, bf16 by value."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and list(port) == list(ref), path
        for k in ref:
            _same(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert isinstance(port, torch.Tensor), path
        ref = np.asarray(ref)
        assert tuple(port.shape) == ref.shape, path
        if port.dtype == torch.bfloat16:
            assert ref.dtype.name == "bfloat16", path
            np.testing.assert_array_equal(port.float().numpy(),
                                          ref.astype(np.float32))
        else:
            assert port.numpy().dtype == ref.dtype, path
            np.testing.assert_array_equal(port.numpy(), ref)
    elif isinstance(ref, list):
        assert isinstance(port, list) and len(port) == len(ref), path
        for i, (a, b) in enumerate(zip(port, ref)):
            _same(a, b, f"{path}[{i}]")
    else:
        assert type(port) is type(ref) and port == ref, (path, port, ref)


def test_decodes_what_flax_writes():
    blob = flax.serialization.msgpack_serialize(_tree())
    _same(msgpack.unpackb(blob), flax.serialization.msgpack_restore(blob))


def test_encodes_the_bytes_flax_writes_and_flax_restores_them():
    """numpy leaves: the same bytes as flax's; torch leaves (a bf16 one
    included): a file flax restores to the same values."""
    tree = _tree()
    ours = msgpack.packb(tree)
    assert ours == flax.serialization.msgpack_serialize(tree)
    as_torch = {
        "w": torch.randn(4, 3, generator=torch.Generator().manual_seed(1)),
        "h": torch.randn(6, generator=torch.Generator().manual_seed(2)).to(
            torch.bfloat16),
        "n": torch.tensor(3, dtype=torch.int32),
        "nest": {"x": None, "y": [1.5, "s"]},
    }
    back = flax.serialization.msgpack_restore(msgpack.packb(as_torch))
    np.testing.assert_array_equal(back["w"], as_torch["w"].numpy())
    assert back["h"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(back["h"].astype(np.float32),
                                  as_torch["h"].float().numpy())
    assert back["n"].dtype == np.int32 and int(back["n"]) == 3
    assert back["nest"] == {"x": None, "y": [1.5, "s"]}


def test_round_trip_keeps_dtypes_and_values():
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": torch.randn(2, 2).to(torch.bfloat16),
            "c": torch.randn(3, dtype=torch.float64)}
    got = msgpack.unpackb(msgpack.packb(tree))
    for k, v in tree.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_refuses_complex_chunked_and_trailing_bytes():
    with pytest.raises(msgpack.MsgpackError, match="ext type 2"):
        msgpack.unpackb(flax.serialization.msgpack_serialize({"z": 1 + 2j}))
    chunked = flax.serialization.msgpack_serialize(
        {"w": {"__msgpack_chunked_array__": True, "shape": {"0": 2}}})
    with pytest.raises(msgpack.MsgpackError, match="chunked"):
        msgpack.unpackb(chunked)
    with pytest.raises(msgpack.MsgpackError, match="after the msgpack"):
        msgpack.unpackb(msgpack.packb({"a": 1}) + b"\x00")
    with pytest.raises(msgpack.MsgpackError, match="truncated"):
        msgpack.unpackb(msgpack.packb({"a": "long string"})[:-3])
    with pytest.raises(msgpack.MsgpackError, match="cannot encode"):
        msgpack.packb({"a": object()})
