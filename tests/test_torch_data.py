"""The port's token-shard dataset against the JAX package's, on the CPU.

``write_token_shard`` must write JAX's bytes; for the same shards, shuffle
seed, batch size and ``rank``/``world_size`` both packages must yield the
same batches, on the native reader (each built from its own copy of
``tokenshard.cpp``) and on the numpy path; a ``state_dict`` taken mid-epoch
must resume to the same stream. The port's reader is built under the
repository's ``build/native/`` and nowhere in the package. Every comparison
is exact.
"""

import itertools
import shutil
from pathlib import Path

import numpy as np
import pytest

from neuronx_distributed_tpu.data import loader as jloader
from neuronx_distributed_tpu_torch.data import loader as tloader
from neuronx_distributed_tpu_torch.kernels import _build

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ toolchain for the native reader")


@pytest.fixture
def shards(tmp_path):
    rs = np.random.RandomState(0)
    paths = []
    for i, n in enumerate((7, 10, 4)):
        p = str(tmp_path / f"shard_{i}.bin")
        tloader.write_token_shard(p, rs.randint(0, 5000, (n, 24)).astype(np.int32))
        paths.append(p)
    return paths


def test_write_token_shard_writes_jax_bytes(tmp_path):
    toks = np.random.RandomState(1).randint(-5, 1 << 20, (5, 9))
    a, b = str(tmp_path / "a" / "x.bin"), str(tmp_path / "b" / "x.bin")
    jloader.write_token_shard(a, toks)
    tloader.write_token_shard(b, toks)
    assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError, match="num_seqs, seq_len"):
        tloader.write_token_shard(b, toks[0])


def _take(ds, n):
    return [b for b in itertools.islice(iter(ds), n)]


@pytest.mark.parametrize("native", [pytest.param(True, marks=needs_gxx), False])
@pytest.mark.parametrize("shuffle,seed,batch,rank,world", [
    (True, 3, 4, 0, 1), (True, 0, 5, 1, 2), (False, 0, 3, 2, 3)])
def test_batches_equal_jax(shards, native, shuffle, seed, batch, rank, world):
    """Five epochs' worth of batches (remainders carried across epochs) are
    JAX's, ids and labels; the stream positions agree."""
    kw = dict(batch_size=batch, shuffle=shuffle, shuffle_seed=seed, native=native, rank=rank,
              world_size=world)
    j, t = jloader.TokenShardDataset(shards, **kw), tloader.TokenShardDataset(shards, **kw)
    assert t.using_native == native == j.using_native
    n = 5 * (21 // world) // batch + 1
    for bj, bt in zip(_take(j, n), _take(t, n)):
        np.testing.assert_array_equal(bt["ids"], bj["ids"])
        np.testing.assert_array_equal(bt["labels"], bj["labels"])
    assert t.state_dict() == j.state_dict()


@pytest.mark.parametrize("native", [pytest.param(True, marks=needs_gxx), False])
def test_mid_epoch_state_resumes_the_stream(shards, native):
    full = tloader.TokenShardDataset(shards, batch_size=4, shuffle_seed=7, native=native)
    want = _take(full, 12)
    first = tloader.TokenShardDataset(shards, batch_size=4, shuffle_seed=7, native=native)
    _take(first, 7)
    state = first.state_dict()
    assert state == {"epoch": 1, "cursor": 7, "shuffle_seed": 7}
    resumed = tloader.TokenShardDataset(shards, batch_size=4, shuffle_seed=7, native=native)
    resumed.load_state_dict(state)
    for a, b in zip(_take(resumed, 5), want[7:]):
        np.testing.assert_array_equal(a["ids"], b["ids"])
    other = tloader.TokenShardDataset(shards, batch_size=4, shuffle_seed=8, native=native)
    with pytest.raises(ValueError, match="shuffle_seed"):
        other.load_state_dict(state)


@needs_gxx
def test_reader_builds_under_build_native_only(shards):
    tloader.TokenShardDataset(shards, batch_size=2, native=True)
    src = Path(tloader.__file__).resolve().parent / "_native"
    assert sorted(p.name for p in src.iterdir()) == ["tokenshard.cpp"]
    built = _build.native_library(src / "tokenshard.cpp")
    assert built.parent == _build.NATIVE_DIR and built.exists()
    assert built.parent == Path(_build.__file__).resolve().parents[2] / "build" / "native"


def test_native_request_raises_when_the_build_fails(shards, monkeypatch):
    def broken(source):
        raise RuntimeError("g++ failed on tokenshard.cpp")

    monkeypatch.setattr(_build, "native_library", broken)
    monkeypatch.setattr(tloader, "_lib", None)
    monkeypatch.setattr(tloader, "_lib_error", None)
    with pytest.raises(RuntimeError, match="did not build"):
        tloader.TokenShardDataset(shards, batch_size=2, native=True)
    fallback = tloader.TokenShardDataset(shards, batch_size=2, native=None)
    assert not fallback.using_native
    assert next(iter(fallback))["ids"].shape == (2, 24)


def test_bad_shards_rejected(tmp_path, shards):
    p = str(tmp_path / "junk.bin")
    open(p, "wb").write(b"\x00" * 64)
    with pytest.raises(ValueError, match="not a token shard"):
        tloader.TokenShardDataset([p], batch_size=2)
    with pytest.raises(ValueError, match="cannot shard"):
        tloader.TokenShardDataset(shards[2:], batch_size=2, world_size=5)
