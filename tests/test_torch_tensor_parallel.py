"""The encoder's tensor parallelism in the port
(``openintel_tpu_torch.parallel.tensor``, ``models.encoder.
param_partition_specs``, ``models.train.train_encoder(mesh=...)``) against
the JAX package's, on the CPU.

The JAX side runs on the 8 virtual devices of ``tests/conftest.py``; the
port's meshes are host stand-ins (``make_mesh(..., device="cpu")``).
``param_partition_specs`` is the reference's tree leaf by leaf; shards
gather back bit for bit and ``qkv``'s shards hold whole heads of q, k and
v. The tensor-parallel encode equals the port's unsharded ``encode`` and
the reference's sharded one within 2e-4 (f32) or 2e-2 (bf16). Mesh
training follows the port's one-device run (losses within rtol 2e-3,
atol 2e-4, the reference's tolerance for its own mesh test), reruns bit
for bit, and its checkpoint is the reference's npz: a JAX mesh checkpoint
resumes on both packages' meshes to the same losses, and a port mesh
checkpoint resumes on one device, on another mesh shape and in the
reference.
"""

import filecmp
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openintel_tpu.models import encoder as JE
from openintel_tpu.models import train as JT
from openintel_tpu.parallel.mesh import make_mesh as j_make_mesh
from openintel_tpu_torch import convert
from openintel_tpu_torch.models import checkpoint as tck
from openintel_tpu_torch.models.encoder import (
    EncoderConfig,
    encode,
    init_params,
    param_partition_specs,
    param_tree,
)
from openintel_tpu_torch.models.train import load_embedder, train_encoder
from openintel_tpu_torch.parallel import tensor as tp
from openintel_tpu_torch.parallel.mesh import Mesh, PartitionSpec, make_mesh

CPU = "cpu"
LOSS_TOL = dict(rtol=2e-3, atol=2e-4)  # the reference's mesh test
ENC_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
KW = dict(vocab_size=256, dim=32, depth=1, heads=4, max_len=16)  # the reference's mesh test config
CFG, JCFG = EncoderConfig(**KW), JE.EncoderConfig(**KW)
RUN = dict(batch_size=4, lr=3e-3, seed=5)
TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "lazy dogs sleep all day long in the sun",
    "market speculation calls puts options yolo",
    "earnings report scheduled for tuesday morning",
    "rocket moon breakout bull run momentum",
    "bearish drill crash dump sell everything",
] * 3


def cpu_mesh(data, corpus):
    return make_mesh(data=data, corpus=corpus, device=CPU)


def jax_mesh(data, corpus):
    return j_make_mesh(data=data, corpus=corpus, devices=jax.devices()[: data * corpus])


@pytest.fixture(scope="module")
def one_device():
    """The port's one-device run of the reference's mesh test (8 steps)."""
    return train_encoder(TEXTS, CFG, steps=8, device=CPU, **RUN)


@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("axis", ["corpus", "model"])
def test_param_partition_specs_equal_the_reference(depth, axis):
    got = param_partition_specs(EncoderConfig(depth=depth), model_axis=axis)
    want = JE.param_partition_specs(JE.EncoderConfig(depth=depth), model_axis=axis)
    g_leaves, g_def = jax.tree_util.tree_flatten(got, is_leaf=lambda x: isinstance(x, PartitionSpec))
    w_leaves, w_def = jax.tree_util.tree_flatten(want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert str(g_def).replace("PartitionSpec", "*") == str(w_def).replace("PartitionSpec", "*")
    assert len(g_leaves) == len(w_leaves) == 4 + 8 * depth
    for g, w in zip(g_leaves, w_leaves):
        assert isinstance(g, PartitionSpec) and isinstance(g, tuple)
        assert tuple(g) == tuple(w) and g == w
    assert repr(PartitionSpec(None, axis)) == repr(jax.sharding.PartitionSpec(None, axis))


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_shards_gather_back_bit_exactly_and_qkv_holds_whole_heads(parts):
    model = init_params(torch.Generator().manual_seed(1), EncoderConfig(**{**KW, "depth": 2}))
    tree = param_tree(model, lambda p: p.detach())
    shards = tp.shard_tree(tree, parts)
    back = tp.gather_tree(shards)
    flat, flat_back, flat_shards = tck.flatten(tree), tck.flatten(back), tp.flat_leaves(shards)
    assert flat.keys() == flat_back.keys()
    for key in flat:
        np.testing.assert_array_equal(flat_back[key], flat[key], err_msg=key)
        name = key.rsplit("/", 1)[-1]
        assert len(flat_shards[key]) == (parts if name in ("qkv", "proj", "fc1", "fc2") else 1), key
    dim, width = KW["dim"], KW["dim"] // parts
    head_dim = dim // KW["heads"]
    for i in range(2):
        qkv = flat[f"blocks/{i}/qkv"]
        for m, shard in enumerate(flat_shards[f"blocks/{i}/qkv"]):
            cols = np.concatenate([t * dim + np.arange(m * width, (m + 1) * width) for t in range(3)])
            np.testing.assert_array_equal(shard.numpy(), qkv[:, cols])
            heads = {(c % dim) // head_dim for c in cols}
            assert len(heads) * head_dim * 3 == len(cols)  # whole heads, each of q, k and v
        for name, axis in (("proj", 0), ("fc1", 1), ("fc2", 0)):
            full = flat[f"blocks/{i}/{name}"]
            for m, shard in enumerate(flat_shards[f"blocks/{i}/{name}"]):
                np.testing.assert_array_equal(shard.numpy(), np.split(full, parts, axis=axis)[m])


def test_sharded_encoder_gathers_back_to_the_same_encoder():
    model = init_params(torch.Generator().manual_seed(2), CFG)
    sharded = tp.shard_encoder(model, cpu_mesh(2, 4))
    assert len(sharded.parameters()) == 2 + 2 + 4 + 4 * 4  # embeddings, ln_f, ln1 and ln2, 4 split leaves x 4
    back = tp.gather_encoder(sharded)
    for (name, a), b in zip(model.named_parameters(), back.parameters()):
        assert torch.equal(a, b), name


def _batch(rng, b, s, vocab):
    ids = rng.integers(1, vocab, size=(b, s)).astype(np.int32)
    lens = rng.integers(1, s + 1, size=b)
    mask = np.arange(s)[None] < lens[:, None]
    return np.where(mask, ids, 0), mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("data,corpus,heads", [(4, 2, 2), (2, 4, 4)])
def test_tensor_parallel_encode_matches_both_encoders(data, corpus, heads, dtype):
    """The reference's ``test_tensor_parallel_encode_on_mesh`` setup (its
    config, heads 4 for a model axis of 4, a batch of 8 x 16), the same
    weights on both sides."""
    kw = dict(vocab_size=512, dim=32, depth=2, heads=heads, max_len=16, dtype=dtype)
    cfg = EncoderConfig(**kw)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    ids, mask = _batch(np.random.default_rng(5), 8, 16, cfg.vocab_size)
    t_ids, t_mask = torch.from_numpy(ids), torch.from_numpy(mask)
    with torch.no_grad():
        got = tp.shard_encoder(model, cpu_mesh(data, corpus))(t_ids, t_mask).numpy()
        plain = encode(model, t_ids, t_mask).numpy()
    jcfg = JE.EncoderConfig(**kw)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(data, corpus), ("data", "corpus"))
    specs = JE.param_partition_specs(jcfg, model_axis="corpus")
    params = jax.tree_util.tree_map(
        lambda a, s: jax.device_put(jnp.asarray(a), jax.sharding.NamedSharding(mesh, s)),
        convert.encoder_tree(model), specs,
    )
    rows = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data", None))
    want = jax.jit(lambda p, i, m: JE.encode(p, jcfg, i, m))(
        params, jax.device_put(ids, rows), jax.device_put(mask, rows)
    )
    np.testing.assert_allclose(got, plain, rtol=0, atol=ENC_TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0, atol=ENC_TOL[dtype])


@pytest.mark.parametrize("data,corpus", [(2, 4), (1, 4), (2, 2)])
def test_mesh_training_follows_one_device(one_device, data, corpus):
    """The reference's mesh test on the port: every step's loss within its
    tolerance of the one-device run; a rerun bit for bit."""
    runs = [train_encoder(TEXTS, CFG, steps=8, mesh=cpu_mesh(data, corpus), device=CPU, **RUN) for _ in range(2)]
    np.testing.assert_allclose(runs[0].losses, one_device.losses, **LOSS_TOL)
    assert runs[0].losses == runs[1].losses
    for a, b, c in zip(runs[0].params.parameters(), runs[1].params.parameters(), one_device.params.parameters()):
        assert torch.equal(a, b) and a.shape == c.shape
        np.testing.assert_allclose(a.detach().numpy(), c.detach().numpy(), rtol=0, atol=1e-3)


@pytest.mark.parametrize("case", ["heads", "batch"])
def test_refusals_are_the_reference_texts(case):
    cfg_kw, batch = ({**KW, "heads": 2}, 4) if case == "heads" else (KW, 3)
    with pytest.raises(ValueError) as got:
        train_encoder(TEXTS, EncoderConfig(**cfg_kw), steps=1, batch_size=batch, mesh=cpu_mesh(2, 4), device=CPU)
    with pytest.raises(ValueError) as want:
        JT.train_encoder(TEXTS, JE.EncoderConfig(**cfg_kw), steps=1, batch_size=batch, mesh=jax_mesh(2, 4))
    assert str(got.value) == str(want.value)
    assert ("must divide heads (2)" if case == "heads" else "must divide by the data axis (2)") in str(got.value)


def _losses_close(a, b):
    assert len(a) == len(b)
    np.testing.assert_allclose(a, b, **LOSS_TOL)


def test_jax_mesh_checkpoint_resumes_on_both_meshes(tmp_path):
    """The reference trains 4 steps on its 2 x 4 mesh; each package resumes
    the checkpoint to step 8 on its own 2 x 4 mesh: the same losses, and
    the port's gathered checkpoint serves in the reference's
    ``load_embedder`` as in the port's."""
    JT.train_encoder(TEXTS, JCFG, steps=4, mesh=jax_mesh(2, 4), ckpt_dir=tmp_path / "j", ckpt_every=100, **RUN)
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    want = JT.train_encoder(TEXTS, JCFG, steps=8, mesh=jax_mesh(2, 4), ckpt_dir=tmp_path / "j", ckpt_every=100, **RUN)
    logs = []
    got = train_encoder(TEXTS, CFG, steps=8, mesh=cpu_mesh(2, 4), ckpt_dir=tmp_path / "t", ckpt_every=100,
                        log=logs.append, device=CPU, **RUN)
    assert "resumed from step 4" in logs and len(got.losses) == 4
    _losses_close(got.losses, want.losses)
    with np.load(tmp_path / "t" / "encoder.npz") as t, np.load(tmp_path / "j" / "encoder.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        assert all(t[k].shape == j[k].shape and t[k].dtype == j[k].dtype for k in j.files)
        assert int(t["opt/0/.count"]) == 8
    texts = ["lazy dog", "market yolo calls", "", "the quick brown fox jumps"]
    np.testing.assert_allclose(
        JT.load_embedder(tmp_path / "t")(texts), load_embedder(tmp_path / "t", device=CPU)(texts), rtol=0, atol=1e-5
    )


@pytest.fixture(scope="module")
def port_mesh_ckpt(tmp_path_factory):
    """The port's 2 x 4 mesh run of 8 steps, checkpointed."""
    d = tmp_path_factory.mktemp("tp_ck")
    res = train_encoder(TEXTS, CFG, steps=8, mesh=cpu_mesh(2, 4), ckpt_dir=d, ckpt_every=100, device=CPU, **RUN)
    return d, res


def test_mesh_checkpoint_is_the_one_device_layout(port_mesh_ckpt, tmp_path):
    """Keys, shapes and dtypes equal a one-device checkpoint's, and the
    gathered params are the run's ``TrainResult.params``."""
    d, res = port_mesh_ckpt
    train_encoder(TEXTS, CFG, steps=1, ckpt_dir=tmp_path, device=CPU, **RUN)
    with np.load(d / "encoder.npz") as a, np.load(tmp_path / "encoder.npz") as b:
        assert {k: (a[k].shape, a[k].dtype) for k in a.files} == {k: (b[k].shape, b[k].dtype) for k in b.files}
        for key, value in tck.flatten(convert.encoder_tree(res.params)).items():
            np.testing.assert_array_equal(a[f"params/{key}"], value)
    assert tck.load_meta(d / "encoder") == tck.load_meta(tmp_path / "encoder") | {"step": 8}


def test_port_mesh_checkpoint_resumes_on_one_device_in_both_packages(port_mesh_ckpt, tmp_path):
    d, _ = port_mesh_ckpt
    shutil.copytree(d, tmp_path / "t")
    shutil.copytree(d, tmp_path / "j")
    logs = []
    got = train_encoder(TEXTS, CFG, steps=10, ckpt_dir=tmp_path / "t", ckpt_every=100, log=logs.append,
                        device=CPU, **RUN)
    assert any("resumed from step 8" in m for m in logs) and len(got.losses) == 2
    want = JT.train_encoder(TEXTS, JCFG, steps=10, ckpt_dir=tmp_path / "j", ckpt_every=100, **RUN)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)


@pytest.mark.parametrize("data,corpus", [(2, 2), (1, 4)])
def test_port_mesh_checkpoint_resumes_on_another_mesh(port_mesh_ckpt, tmp_path, data, corpus):
    """_restore cuts a checkpoint of any mesh shape into this mesh's
    shards: two more steps on it follow two more on one device."""
    d, _ = port_mesh_ckpt
    shutil.copytree(d, tmp_path / "mesh")
    shutil.copytree(d, tmp_path / "one")
    on_mesh = train_encoder(TEXTS, CFG, steps=10, ckpt_dir=tmp_path / "mesh", mesh=cpu_mesh(data, corpus),
                            device=CPU, **RUN)
    one = train_encoder(TEXTS, CFG, steps=10, ckpt_dir=tmp_path / "one", device=CPU, **RUN)
    _losses_close(on_mesh.losses, one.losses)
    with np.load(tmp_path / "mesh" / "encoder.npz") as a, np.load(tmp_path / "one" / "encoder.npz") as b:
        for key in b.files:
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-4, err_msg=key)


def test_resume_at_or_past_the_request_on_a_mesh_does_nothing(port_mesh_ckpt, tmp_path):
    d, res = port_mesh_ckpt
    shutil.copytree(d, tmp_path / "ck")
    again = train_encoder(TEXTS, CFG, steps=6, ckpt_dir=tmp_path / "ck", mesh=cpu_mesh(2, 4), device=CPU, **RUN)
    assert again.losses == [] and again.step == 8
    for a, b in zip(again.params.parameters(), res.params.parameters()):
        assert torch.equal(a, b)
    for name in ("encoder.json", "encoder.npz"):
        assert filecmp.cmp(tmp_path / "ck" / name, d / name, shallow=False)


def test_mesh_over_several_processes_is_refused():
    mesh = cpu_mesh(1, 4)
    mesh.world = 2  # as one rank of a two-process group sees it
    with pytest.raises(ValueError, match="spans 2 processes"):
        train_encoder(TEXTS, CFG, steps=1, mesh=mesh, device=CPU, **RUN)


def test_device_of_another_type_than_the_mesh_is_refused():
    with pytest.raises(ValueError, match="is not the mesh's"):
        train_encoder(TEXTS, CFG, steps=1, mesh=cpu_mesh(1, 2), device="cuda", **RUN)
    cuda_mesh = Mesh([[torch.device("cuda", 0)] * 2])
    with pytest.raises(ValueError, match="is not the mesh's"):
        train_encoder(TEXTS, CFG, steps=1, mesh=cuda_mesh, device=CPU, **RUN)
