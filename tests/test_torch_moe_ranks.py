"""``moe_forward`` on a mesh of ``torch.distributed`` ranks, on the CPU.

One :func:`repro_torch.distributed.start` a module runs 8 gloo ranks;
each calls the port's ``moe_forward`` on the same global inputs in
every case, cuts its own block by the reference's ``shard_map`` specs,
and hands back its output block and aux loss:

* ``"replicated"`` on a (4, 2) ``("data", "model")`` mesh: experts
  sharded over "model", one all-reduce to combine;
* ``"a2a"`` on the same mesh: experts over "data", the expert ffn split
  over "model", routed copies through ``all_to_all`` and back;
* the tensor-parallel fallback: 6 experts on a (2, 4) mesh, which do
  not divide the 4 model ranks, so every rank holds all experts with a
  quarter of their ffn dim.

As ``tests/_moe_dist_check.py`` does on the JAX package (capacity
factor 4, so no copy is dropped), each rank's block equals the JAX
``_moe_local`` output over the whole batch, sliced at the rank's data
coordinate, within 2e-4, and every rank's aux equals the mean over the
data blocks of the JAX ``_route`` aux of each block (the reference's
``pmean``).  The JAX references run in this process while the ranks do.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.moe import moe_defs  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402

from _torch_jax import run_fast  # noqa: E402

BASE = ModelConfig(
    arch="moe-dist-check", family="moe", n_layers=1, d_model=32,
    n_heads=4, n_kv_heads=4, head_dim=8, d_ff=0, vocab_size=64,
    n_experts=8, top_k=2, expert_d_ff=64, n_shared_experts=1,
    capacity_factor=4.0)
# name -> (mesh shape over ("data", "model"), config changes)
CASES = {"replicated": ((4, 2), dict(moe_dispatch="replicated")),
         "a2a": ((4, 2), dict(moe_dispatch="a2a")),
         "tp_ffn": ((2, 4), dict(n_experts=6))}
AXES = ("data", "model")
TOL = dict(rtol=2e-4, atol=2e-4)


def case_inputs(name):
    """The config, float32 numpy parameters and x (8, 16, 32) of a case,
    the same in the ranks and in this process."""
    cfg = dataclasses.replace(BASE, **CASES[name][1])
    rng = np.random.default_rng(sum(map(ord, name)))

    def draw(d):
        x = rng.normal(size=d.shape).astype(np.float32)
        return x * np.float32(d.scale * d.shape[-2] ** -0.5)

    params = tree_map(draw, moe_defs(cfg))
    x = rng.normal(size=(8, 16, cfg.d_model)).astype(np.float32)
    return cfg, params, x


def rank_moe(rank):
    """Run on each of the 8 ranks: every case's output block, aux and
    data coordinate; rank 0 returns all ranks'."""
    import torch.distributed as dist
    from repro_torch.distributed import Planner, make_mesh
    from repro_torch.models.moe import moe_forward

    torch.set_num_threads(1)
    res = {"rank": rank}
    for name, (shape, _) in CASES.items():
        cfg, params, x = case_inputs(name)
        mesh = make_mesh(shape, AXES)
        p = tree_map(torch.from_numpy, params)
        out, aux = moe_forward(p, torch.from_numpy(x), cfg, Planner(mesh))
        res[name] = (mesh.coords["data"], out.numpy(), float(aux))
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, res)
    return everyone


@pytest.fixture(scope="module")
def ranks():
    """The 8 ranks' results, started before the JAX references compile."""
    from repro_torch.distributed import start
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    started = start(rank_moe, 8, backend="gloo", device="cpu", timeout=300)
    try:
        yield functools.lru_cache(maxsize=None)(started.result)
    finally:
        started.stop()
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def references(ranks):
    """Per case: the JAX ``_moe_local`` output over the whole batch and
    the mean of each data block's ``_route`` aux."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import config as jconfig
    from repro.models import moe as jmoe

    out = {}
    for name, (shape, _) in CASES.items():
        cfg, params, x = case_inputs(name)
        jcfg = jconfig.ModelConfig(**dataclasses.asdict(cfg))
        n_data = shape[0]

        def ref(p, x, jcfg=jcfg, n_data=n_data):
            blocks = x.reshape(n_data, -1, x.shape[-1])
            auxes = [jmoe._route(p, b, jcfg)[2] for b in blocks]
            return jmoe._moe_local(p, x, jcfg), jnp.mean(jnp.stack(auxes))

        y, aux = run_fast(jax.jit(ref), jax.tree.map(jnp.asarray, params),
                          jnp.asarray(x))
        out[name] = (np.asarray(y), float(aux), n_data)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_moe_forward_on_ranks_equals_jax_local(ranks, references, name):
    want, want_aux, n_data = references[name]
    results = ranks()
    assert [r["rank"] for r in results] == list(range(8))
    rows = want.shape[0] // n_data
    seen = set()
    for r in results:
        coord, got, aux = r[name]
        seen.add(coord)
        np.testing.assert_allclose(got, want[coord * rows:(coord + 1) * rows],
                                   **TOL)
        np.testing.assert_allclose(aux, want_aux, rtol=1e-5)
    assert seen == set(range(n_data))


def test_cases_take_their_dispatch_paths():
    """replicated shards the 8 experts over "model"; a2a routes over
    "data"; 6 experts on 4 model ranks fall back to the split ffn."""
    from repro_torch.models.moe import ep_axes_for
    assert ep_axes_for(case_inputs("a2a")[0], {"data": 4, "model": 2}) == \
        (("data",), 4)
    cfg = case_inputs("tp_ffn")[0]
    assert cfg.n_experts % 4 and cfg.moe_dispatch == "replicated"
    assert cfg.expert_d_ff % 4 == 0
