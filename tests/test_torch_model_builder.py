"""The port's model builder against the JAX package's.

- Routing (JAX ``tests/test_inference.py:100``): the smallest padding that
  fits, exact shapes first, ``ValueError`` when nothing fits; on seeded
  shape ladders the port picks JAX ``NxDModel.run``'s bucket every time.
- Bundles (``:346``): ``save_model``/``load_model`` round-trip through
  ``torch.export`` and serve without the function's code; a loaded body that
  reaches the flash kernel's operator still calls it.
- Weight shards (``:376``): the port writes the JAX package's per-rank
  files and ``shard_meta.json``; files written by either side load in the
  other; a safetensors file written here is byte for byte the one
  ``safetensors.numpy`` writes.

Tolerance: shapes and bytes exact; program outputs equal bit for bit
(fp32, the same function on the same inputs) except the JAX-vs-port bundle
outputs, held within 1e-6 relative (two frameworks' tanh).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from safetensors.numpy import load_file, save_file

from neuronx_distributed_tpu.inference import model_builder as jmb
from neuronx_distributed_tpu.parallel import mesh as jmesh
from neuronx_distributed_tpu_torch.inference import model_builder as tmb
from neuronx_distributed_tpu_torch.kernels.flash_attn import flash_block_forward
from neuronx_distributed_tpu_torch.models import llama as tl


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs several workers on the machine's
    cores, and torch's default pool would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bucket_router():
    calls = []

    def fn(x):
        calls.append(tuple(x.shape))
        return x * 2.0

    nxd = (tmb.ModelBuilder()
           .add("f", fn, (torch.zeros((4, 8)),))
           .add("f", fn, (torch.zeros((4, 16)),))
           .trace(device="cpu"))
    out = nxd.run("f", torch.ones((4, 6)))
    assert out.shape == (4, 8) and calls == [(4, 8)]
    np.testing.assert_array_equal(out[:, :6].numpy(), 2.0)
    np.testing.assert_array_equal(out[:, 6:].numpy(), 0.0)
    assert nxd.run("f", torch.ones((4, 16))).shape == (4, 16)
    with pytest.raises(ValueError, match="no bucket"):
        nxd.run("f", torch.ones((4, 32)))
    assert nxd.keys() == ["f"] and nxd.buckets("f") == [((4, 8),), ((4, 16),)]


@pytest.mark.parametrize("seed", range(3))
def test_routing_picks_jax_bucket(seed):
    rng = np.random.default_rng(seed)
    ladder = [(int(rng.integers(1, 9)), int(rng.integers(1, 65))) for _ in range(6)]
    ladder = list(dict.fromkeys(ladder))
    jb, tb = jmb.ModelBuilder(), tmb.ModelBuilder()
    for a, b in ladder:
        jb.add("g", lambda x, y: (x, y), (jnp.zeros((a, b)), jnp.zeros((b,))))
        tb.add("g", lambda x, y: (x, y), (torch.zeros((a, b)), torch.zeros((b,))))
    jm, tm = jb.trace(), tb.trace(device="cpu")
    for _ in range(12):
        a, b = int(rng.integers(1, 9)), int(rng.integers(1, 65))
        try:
            want = tuple(jm.run("g", jnp.ones((a, b)), jnp.ones((b,)))[0].shape)
        except ValueError:
            with pytest.raises(ValueError):
                tm.run("g", torch.ones((a, b)), torch.ones((b,)))
            continue
        got = tm.route("g", torch.ones((a, b)), torch.ones((b,))).example_args[0].shape
        assert tuple(got) == want, (ladder, (a, b))
        assert tuple(tm.run("g", torch.ones((a, b)), torch.ones((b,)))[0].shape) == want


def test_pad_to():
    x = torch.arange(6.0).reshape(2, 3)
    y = tmb.pad_to(x, (3, 5))
    assert y.shape == (3, 5) and torch.equal(y[:2, :3], x) and y.sum() == x.sum()
    assert tmb.pad_to(x, (2, 3)) is x
    with pytest.raises(ValueError):
        tmb.pad_to(x, (1, 3))


def test_save_load_roundtrip(tmp_path):
    w = np.random.RandomState(0).randn(8, 8).astype(np.float32)
    tw = torch.from_numpy(w)

    def fn(x):
        return torch.tanh(x @ tw)

    mb = tmb.ModelBuilder()
    mb.add("enc", fn, (torch.zeros((2, 8)),))
    mb.add("enc", fn, (torch.zeros((4, 8)),), donate_argnums=(0,))
    model = mb.trace(device="cpu")
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 8).astype(np.float32))
    golden = model.run("enc", x)
    tmb.save_model(model, str(tmp_path / "bundle"))
    files = sorted(os.listdir(tmp_path / "bundle"))
    assert files == ["enc_0.pt2", "enc_1.pt2", "manifest.json"]
    import json

    manifest = json.loads((tmp_path / "bundle" / "manifest.json").read_text())
    assert manifest == {"enc": [{"file": "enc_0.pt2", "donate_argnums": []},
                                {"file": "enc_1.pt2", "donate_argnums": [0]}]}
    del fn, model
    loaded = tmb.load_model(str(tmp_path / "bundle"))
    assert loaded.keys() == ["enc"] and loaded.buckets("enc") == [((2, 8),), ((4, 8),)]
    assert torch.equal(loaded.run("enc", x), golden)
    out3 = loaded.run("enc", torch.from_numpy(np.random.RandomState(2).randn(3, 8)
                                              .astype(np.float32)))
    assert out3.shape == (4, 8)
    # the JAX bundle's answer on the same input
    jm = jmb.ModelBuilder().add("enc", lambda v: jnp.tanh(v @ jnp.asarray(w)),
                                (jnp.zeros((2, 8)),)).trace()
    np.testing.assert_allclose(golden.numpy(), np.asarray(jm.run("enc", jnp.asarray(x.numpy()))),
                               rtol=1e-6, atol=1e-6)


def test_bundle_keeps_the_flash_operator(tmp_path):
    """A prefill body with the weights as arguments: the exported graph
    calls ``nxdt_torch::flash_fwd`` and holds no weight."""
    cfg = tl.LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1,
                         num_heads=4, num_kv_heads=2, max_seq_len=128, dtype=torch.float32,
                         remat_policy=None)
    params = tl.init_params(cfg, torch.Generator().manual_seed(0))
    with torch.device("meta"):
        model = tl.LlamaForCausalLM(cfg)
    names = sorted(params)

    def fn(ids, *w):
        return torch.func.functional_call(model, dict(zip(names, w)), (ids,))[:, -1]

    ids = torch.randint(0, 64, (1, 128))
    weights = [params[n] for n in names]
    live = tmb.ModelBuilder().add("prefill", fn, (ids, *weights)).trace(device="cpu")
    want = live.run("prefill", ids, *weights)
    tmb.save_model(live, str(tmp_path / "b"))
    import zipfile

    with zipfile.ZipFile(tmp_path / "b" / "prefill_0.pt2") as z:   # no tensor data inside
        data = sum(i.file_size for i in z.infolist() if "/data/" in i.filename)
    assert data < 100
    loaded = tmb.load_model(str(tmp_path / "b"))
    ops = {str(n.target) for n in torch.export.load(str(tmp_path / "b" / "prefill_0.pt2"))
           .graph.nodes if n.op == "call_function"}
    assert "nxdt_torch.flash_fwd.default" in ops
    before = flash_block_forward.launches
    assert torch.equal(loaded.run("prefill", ids, *weights), want)
    assert flash_block_forward.launches == before   # CPU tensors: the twin, no launch


@pytest.mark.parametrize("dtypes", [("float32", "int8", "int64"),
                                    ("float16", "float64", "bool", "uint8", "int32")])
def test_safetensors_bytes_equal_safetensors_numpy(tmp_path, dtypes):
    rng = np.random.default_rng(len(dtypes))
    tensors = {}
    for i, dt in enumerate(dtypes):
        shape = [(3, 5), (7,), (), (0, 4), (2, 2, 2)][i % 5]
        tensors[f"t{i}_{dt}"] = np.asarray(rng.standard_normal(shape) * 50).astype(dt)
    save_file(tensors, str(tmp_path / "ref.safetensors"))
    tmb.save_safetensors(tensors, str(tmp_path / "port.safetensors"))
    assert (tmp_path / "port.safetensors").read_bytes() == \
        (tmp_path / "ref.safetensors").read_bytes()
    back = tmb.load_safetensors(str(tmp_path / "ref.safetensors"))
    assert set(back) == set(tensors)
    for k, v in tensors.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
    bf = torch.randn((4, 3), generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    tmb.save_safetensors({"w": bf}, str(tmp_path / "bf.safetensors"))
    assert torch.equal(tmb.load_safetensors(str(tmp_path / "bf.safetensors"))["w"], bf)


def test_shard_weights_cross_both_ways(tmp_path):
    params = {"a": {"kernel": np.arange(32, dtype=np.float32).reshape(4, 8),
                    "bias": np.ones(8, np.float32)},
              "norm": {"scale": np.full(4, 2.0, np.float32)}}
    specs = {"a": {"kernel": P(None, "tp"), "bias": P("tp")}, "norm": {"scale": None}}
    st = jmesh.initialize_model_parallel(tensor_model_parallel_size=4)
    jmb.shard_weights_to_safetensors(params, specs, st.mesh, str(tmp_path / "jax"))
    # in JAX's leaf order: shard_meta.json lists the tensors in the order given
    flat = {"['a']['bias']": params["a"]["bias"], "['a']['kernel']": params["a"]["kernel"],
            "['norm']['scale']": params["norm"]["scale"]}
    dims = {"['a']['kernel']": 1, "['a']['bias']": 0}
    tmb.shard_weights_to_safetensors(flat, dims, 4, str(tmp_path / "port"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert sum(f.endswith(".safetensors") for f in names) == 4
    for f in names:   # the same files, byte for byte
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    r0 = load_file(str(tmp_path / "port" / "weights_rank_0.safetensors"))
    assert r0["['a']['kernel']"].shape == (4, 2) and r0["['norm']['scale']"].shape == (4,)
    for src in ("jax", "port"):
        full = tmb.load_sharded_safetensors(str(tmp_path / src))
        jfull = jmb.load_sharded_safetensors(str(tmp_path / src))
        assert set(full) == set(jfull) == set(flat)
        for k, v in flat.items():
            np.testing.assert_array_equal(full[k].numpy(), v)
            np.testing.assert_array_equal(jfull[k], v)
    with pytest.raises(ValueError, match="not divisible"):
        tmb.shard_weights_to_safetensors({"x": np.zeros((3, 2), np.float32)}, {"x": 0}, 2,
                                         str(tmp_path / "bad"))
