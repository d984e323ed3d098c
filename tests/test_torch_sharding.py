"""The port's sharding rules (``repro_torch.dist.sharding``) against the JAX
package's, leaf for leaf, on the CPU.

The reference takes a ``jax.sharding.AbstractMesh`` (no devices needed) and
abstract trees (``jax.eval_shape``); the port takes its mesh value and meta
tensors.  A spec from the port is a plain tuple and must equal
``tuple()`` of the reference's ``PartitionSpec`` exactly, for every leaf of
every config in ``ARCHITECTURES`` and the paper's two BERT models, on every
mesh of ``MESHES``: parameters, optimizer states, decode caches (dense and
paged, KV sequence sharding both ways) and batches.  Also the mesh
coordinates of a rank and the ``Distribution`` constructors' refusals.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import InputShape as JShape  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import make as jmake_opt  # noqa: E402
from repro.serve import kv as jkv  # noqa: E402
from repro_torch.configs import ARCHITECTURES, PAPER_MODELS, get_config  # noqa: E402
from repro_torch.dist import (  # noqa: E402
    Distribution,
    UnsupportedDistError,
    make_mesh,
    sharding,
)
from repro_torch.dist import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import InputShape  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.optim import make as make_opt  # noqa: E402
from repro_torch.serve.kv import KVState  # noqa: E402

CONFIGS = ARCHITECTURES + PAPER_MODELS
#: 1-D data meshes (one that divides nothing odd, 3 that divides little),
#: the dev mesh with a model axis, and the reference's production meshes
MESHES = [((1,), ("data",)), ((2,), ("data",)), ((3,), ("data",)), ((4,), ("data",)),
          ((8,), ("data",)), ((4, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
MESH_IDS = [",".join(map(str, d)) for d, _ in MESHES]
OPTIMIZERS = ("sgd", "adamw", "lamb", "lans")


def meshes(i: int):
    dims, names = MESHES[i]
    return jax.sharding.AbstractMesh(dims, names), make_mesh(dims, names)


@functools.lru_cache(maxsize=None)
def trees(name: str):
    """The reference's abstract parameter tree and the port's meta tree."""
    jc = jget_config(name)
    return (jc, jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jc)),
            get_config(name), init_params(get_config(name), seed=0, device="meta"))


def ref_specs(tree, shardings) -> dict:
    """{path: tuple(spec)} of a reference tree of NamedShardings."""
    flat = jax.tree_util.tree_flatten_with_path(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {jsh._path_str(kp): tuple(s.spec) for kp, s in flat}


def port_specs(tree, specs) -> dict:
    """{path: spec} of a port tree of specs (walked by ``tree``'s
    structure: a spec is itself a tuple)."""
    out = {}
    paths = sharding.map_with_path(lambda path, x: path, tree)
    sharding.zip_map(lambda path, spec: out.__setitem__(path, spec), paths, specs)
    return out


@pytest.mark.parametrize("mesh", range(len(MESHES)), ids=MESH_IDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_param_specs_match_reference(name, mesh):
    jc, jtree, _, tree = trees(name)
    jm, pm = meshes(mesh)
    want = ref_specs(jtree, jsh.param_shardings(jtree, jm))
    got = port_specs(tree, sharding.param_shardings(tree, pm))
    assert got == want
    # spec_for_path leaf by leaf, and the Distribution's view of it
    dist = Distribution(pm, "cpu") if pm.shape.get("model", 1) == 1 else None
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    for kp, x in flat:
        path = jsh._path_str(kp)
        spec = sharding.spec_for_path(path, x.shape, pm)
        assert spec == tuple(jsh.spec_for_path(path, x.shape, jm)), path
        if dist is not None:
            assert dist.spec_for_path(path, x.shape) == spec


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
@pytest.mark.parametrize("name", CONFIGS)
def test_opt_specs_match_reference(name, optimizer):
    """ZeRO: each moment tree's leaves take their parameter's spec (the
    same suffix rules under the ``m`` / ``v`` / ``mu`` prefix); the step
    count is replicated."""
    _, jtree, _, tree = trees(name)
    jstate = jax.eval_shape(jmake_opt(optimizer, 1e-3).init, jtree)
    state = make_opt(optimizer, 1e-3).init(tree)
    for i in range(len(MESHES)):
        jm, pm = meshes(i)
        want = ref_specs(jstate, jsh.opt_shardings(jstate, jm))
        assert port_specs(state, sharding.opt_shardings(state, pm)) == want, MESH_IDS[i]
        assert want["count"] == ()


def _meta(jtree):
    """The port's meta tensors in a reference tree's shapes and structure."""
    return jax.tree.map(lambda x: torch.empty(tuple(x.shape), device="meta"), jtree)


#: (config, layout): the dense dict and the dense ``KVState`` of every
#: architecture; paged pools (bf16 and int8 with their scales) where the
#: reference pages (not enc-dec: its ``require_chunkable``)
CACHES = ([(n, layout) for n in ARCHITECTURES for layout in ("dense", "dense_kvstate")]
          + [(n, layout) for n in ARCHITECTURES if n != "whisper_tiny"
             for layout in ("paged", "paged_int8")])


@pytest.mark.parametrize("name,layout", CACHES)
def test_cache_specs_match_reference(name, layout):
    """The decode cache's placements at 8 slots of 64 positions,
    ``shard_seq`` both ways, on every mesh, from the reference's own cache
    shapes."""
    jc, jtree, _, _ = trees(name)
    if layout.startswith("dense"):
        jcache = jsteps.abstract_cache(jc, JShape("d", 64, 8, "decode"))
        cache = _meta(jcache)
        if layout == "dense_kvstate":
            jcache, cache = jkv.KVState(data=jcache), KVState(data=cache)
    else:
        spec = jkv.KVCacheSpec(num_slots=8, max_len=64, layout="paged", page_size=16,
                               kv_dtype="int8" if layout == "paged_int8" else None)
        data = jax.eval_shape(lambda p: jkv.Paged.build_data(spec, p, jc), jtree)
        tables = jax.ShapeDtypeStruct((8, spec.blocks_per_slot(jc)), np.int32)
        jcache = jkv.KVState(data=data, tables=tables, page_size=16)
        cache = KVState(data=_meta(data), tables=torch.empty(tables.shape, device="meta"),
                        page_size=16)
    for i in range(len(MESHES)):
        jm, pm = meshes(i)
        for shard_seq in (False, True):
            want = jsh.cache_shardings(jcache, jm, shard_seq=shard_seq)
            got = sharding.cache_shardings(cache, pm, shard_seq=shard_seq)
            if layout == "dense":
                assert port_specs(cache, got) == ref_specs(jcache, want)
                continue
            assert port_specs(cache.data, got.data) == ref_specs(jcache.data, want.data)
            assert got.page_size == cache.page_size
            if layout == "dense_kvstate":
                assert got.tables is None and want.tables is None
            else:
                assert got.tables == tuple(want.tables.spec) == ()


SHAPES = {"train_w8": (JShape("t", 64, 16, "train", microbatches=2), 8),
          "train_w3": (JShape("t", 64, 12, "train", microbatches=2), 3),
          "prefill": (JShape("p", 64, 8, "prefill"), None),
          "decode_b8": (JShape("d", 64, 8, "decode"), None),
          "decode_b1": (JShape("d", 64, 1, "decode"), None)}


@pytest.mark.parametrize("name,shape", [(n, s) for n in CONFIGS for s in sorted(SHAPES)
                                        if n not in PAPER_MODELS or not s.startswith("decode")])
def test_batch_specs_match_reference(name, shape):
    """``batch_shardings``: the batch leaves' leading dim over the data axes,
    the (W, M) latencies fitted to their own shape (3 workers divide
    nothing), a decode step's token and position; the paper's BERT models
    are encoder-only (no decode shape)."""
    jc, _, tc, _ = trees(name)
    jshape, w = SHAPES[shape]
    tshape = InputShape(jshape.name, jshape.seq_len, jshape.global_batch, jshape.mode,
                        microbatches=jshape.microbatches)
    for i in range(len(MESHES)):
        jm, pm = meshes(i)
        want = jsteps.batch_shardings(jc, jshape, jm, n_workers=w)
        got = steps.batch_shardings(tc, tshape, pm, n_workers=w)
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "batch":
                assert got[k] == {b: tuple(s.spec) for b, s in v.items()}, (MESH_IDS[i], k)
            else:
                assert got[k] == tuple(v.spec), (MESH_IDS[i], k)


@pytest.mark.parametrize("dims", [(4,), (2, 3), (2, 2, 1), (2, 4, 2)])
def test_rank_coordinates_are_row_major(dims):
    """Rank r sits at ``np.unravel_index(r, dims)``: the reference's device
    grid, ``np.arange(n).reshape(dims)``."""
    names = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}[len(dims)]
    mesh = make_mesh(dims, names)
    for r in range(mesh.size):
        at = mesh_lib.coords(mesh, r)
        assert tuple(at.values()) == tuple(int(i) for i in np.unravel_index(r, dims))
        assert mesh_lib.rank_of(mesh, **at) == r
    with pytest.raises(ValueError, match="not in mesh"):
        mesh_lib.coords(mesh, mesh.size)


def test_split_dims_follow_the_specs():
    """The dimension each leaf is split along: the spec's "data" entry when
    the data axis is above 1, none on one rank or a pod axis alone."""
    _, _, tc, tree = trees("qwen2_5_3b")
    specs = sharding.leaf_specs(tree, make_mesh((2,), ("data",)))
    dims = Distribution.from_spec("2", device="cpu").split_dims(tree)
    assert dims == [s.index("data") if "data" in s else None for s in specs]
    assert any(d is not None and d > 0 for d in dims)  # stacked leaves: an inner dim
    assert Distribution.from_spec("1", device="cpu").split_dims(tree) == [None] * len(dims)
    assert Distribution.from_spec("2,1,1", device="cpu").split_dims(tree) == [None] * len(dims)


def test_constructors_and_refusals():
    """``for_devices`` builds (data, model) meshes; a model axis above 1, and
    the production meshes' 16-way model axis, are refused."""
    assert Distribution.for_devices(4, device="cpu").mesh == make_mesh((4, 1), ("data", "model"))
    with pytest.raises(UnsupportedDistError, match="model axis"):
        Distribution.for_devices(4, model_parallel=2, device="cpu")
    for multi_pod in (False, True):
        with pytest.raises(UnsupportedDistError, match="model axis"):
            Distribution.production(multi_pod=multi_pod, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="0 devices"):
            Distribution.for_devices()
    d = Distribution.from_spec("2,2,1", device="cpu")
    assert (d.pod_size, d.data_size, d.dp_size) == (2, 2, 4)
    assert d.replicated() == ()
