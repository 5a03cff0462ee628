"""The PyTorch port's foundations against the JAX package, on the CPU.

Hashing bit for bit (int32 here, int64 in an x64 subprocess), the
``Relation`` operators as full arrays, the key-dtype configuration, the
numpy interop, and the port's independence: no module of
``repro_torch`` (nor ``chip_smoke.py``) imports JAX or ``repro``, and
the package imports with JAX blocked.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hashing as jh  # noqa: E402
from repro.core import relation as jrel  # noqa: E402
from repro_torch import config, interop  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core import relation as trel  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
I32_MAX = np.iinfo(np.int32).max


def int32_keys(seed: int, n: int = 4096) -> np.ndarray:
    """Random int32 keys over the whole range, plus the edges: 0, ±1,
    INT32_MIN/MAX and their neighbours."""
    rng = np.random.default_rng(seed)
    edge = np.array([0, 1, -1, 2, I32_MAX, I32_MAX - 1, -I32_MAX - 1,
                     -I32_MAX, 2 ** 30, -(2 ** 30)], np.int64)
    rand = rng.integers(-2 ** 31, 2 ** 31, n)
    return np.concatenate([edge, rand]).astype(np.int32)


# ---------------------------------------------------------------------------
# Hashing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_buckets", [1, 2, 3, 4, 7, 16, 1000, 65537,
                                       1 << 30, 2 ** 31 - 1, 2 ** 32 - 5])
@pytest.mark.parametrize("salt", [0, 1, 2, 3])
def test_bucket_hash_int32_bit_for_bit(salt, n_buckets):
    keys = int32_keys(seed=salt * 7919 + n_buckets % 1000)
    want = np.asarray(jh.bucket_hash(jnp.asarray(keys), n_buckets, salt=salt))
    got = th.bucket_hash(torch.as_tensor(keys), n_buckets, salt=salt)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_h_and_g_are_salted_bucket_hashes():
    keys = torch.as_tensor(int32_keys(seed=3, n=256))
    np.testing.assert_array_equal(th.h(keys, 5).numpy(),
                                  np.asarray(jh.h(jnp.asarray(keys.numpy()), 5)))
    np.testing.assert_array_equal(th.g(keys, 5).numpy(),
                                  np.asarray(jh.g(jnp.asarray(keys.numpy()), 5)))


def test_bucket_hash_keeps_leading_axes():
    keys = int32_keys(seed=11, n=4 * 6 * 8 - 10).reshape(4, 6, 8)
    got = th.bucket_hash(torch.as_tensor(keys), 13, salt=2)
    want = np.asarray(jh.bucket_hash(jnp.asarray(keys), 13, salt=2))
    assert got.shape == (4, 6, 8)
    np.testing.assert_array_equal(got.numpy(), want)


# One x64 subprocess: jax_enable_x64 must be set before JAX creates an
# array, so the main test process stays in 32-bit mode.
_X64_CHECK = r"""
import numpy as np, torch
import jax, jax.numpy as jnp
from repro import config as jcfg
from repro.core import hashing as jh
from repro.core.local import groupby_sum as j_groupby, sort_merge_join as j_smj
from repro.core.relation import Relation as JRel
from repro_torch import config as tcfg
from repro_torch.core import hashing as th
from repro_torch.core.local import groupby_sum as t_groupby, sort_merge_join as t_smj
from repro_torch.core.relation import Relation as TRel

assert jcfg.enable_x64() and jcfg.x64_enabled() and tcfg.x64_enabled()
assert jcfg.key_dtype_name() == tcfg.key_dtype_name() == "int64"
assert tcfg.default_key_dtype() == torch.int64

rng = np.random.default_rng(0)
edge = np.array([0, 1, -1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 7,
                 (3 << 32) + 7, -(2**31), -(2**32) - 1,
                 2**63 - 1, -(2**63), 2**62 + 12345], np.int64)
keys = np.concatenate([edge, rng.integers(-2**63, 2**63 - 1, 4000,
                                          dtype=np.int64)])
for salt in range(4):
    for nb in (3, 1000, 2**32 - 5):
        want = np.asarray(jh.bucket_hash(jnp.asarray(keys), nb, salt=salt))
        got = th.bucket_hash(torch.as_tensor(keys), nb, salt=salt).numpy()
        assert (got == want).all(), (salt, nb)

# int64 keys above 2^32 through the sort-merge join and the group-by.
base, stride = 2**33, 2**32
lk = np.array([base + i % 3 for i in range(12)] + [base + stride] * 2, np.int64)
rk = np.array([base + stride, base + 1, base + 2, base + 1], np.int64)
lv = np.arange(len(lk), dtype=np.float32)
rv = np.arange(len(rk), dtype=np.float32) + 10
jl = JRel.from_arrays(16, b=jnp.asarray(lk), v=jnp.asarray(lv))
jr = JRel.from_arrays(6, b=jnp.asarray(rk), w=jnp.asarray(rv))
tl = TRel.from_arrays(16, b=torch.as_tensor(lk), v=torch.as_tensor(lv))
tr = TRel.from_arrays(6, b=torch.as_tensor(rk), w=torch.as_tensor(rv))
# The reference jitted: one compile instead of one per op, without
# XLA's backend optimizations (the outputs are gathers and integer sums).
from _torch_jax import XLA_FAST
jo, jf = jax.jit(lambda l, r: j_smj(l, r, "b", "b", 32),
                 compiler_options=XLA_FAST)(jl, jr)
to, tf = t_smj(tl, tr, "b", "b", 32)
assert bool(jf) == bool(tf)
assert (np.asarray(jo.valid) == to.valid.numpy()).all()
for n in jo.cols:
    assert to.cols[n].numpy().dtype == np.asarray(jo.cols[n]).dtype, n
    assert (to.cols[n].numpy() == np.asarray(jo.cols[n])).all(), n
jg, jgf = jax.jit(lambda r: j_groupby(r, ("b",), "w", 8),
                  compiler_options=XLA_FAST)(jo)
tg, tgf = t_groupby(to, ("b",), "w", 8)
assert bool(jgf) == bool(tgf)
for n in jg.cols:
    assert (tg.cols[n].numpy() == np.asarray(jg.cols[n])).all(), n
print("X64_OK")
"""


def test_int64_keys_match_jax_under_x64():
    """int64 keys — negatives, words near 2^32 and 2^63 — hash bit for
    bit, join and group equal to the JAX package with x64 on."""
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", _X64_CHECK], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "X64_OK" in res.stdout


# ---------------------------------------------------------------------------
# Relation
# ---------------------------------------------------------------------------

def both(cols: dict, valid: np.ndarray):
    """The same relation in both packages."""
    j = jrel.Relation({n: jnp.asarray(c) for n, c in cols.items()},
                      jnp.asarray(valid))
    t = interop.relation_from_numpy(cols, valid, device="cpu")
    return j, t


def assert_same(j, t):
    cols, valid = interop.relation_to_numpy(t)
    assert sorted(cols) == sorted(j.cols)
    np.testing.assert_array_equal(valid, np.asarray(j.valid))
    for n, c in cols.items():
        want = np.asarray(j.cols[n])
        assert c.dtype == want.dtype, n
        np.testing.assert_array_equal(c, want, err_msg=n)


def sample(seed: int, cap: int = 24):
    rng = np.random.default_rng(seed)
    cols = {"a": rng.integers(-5, 50, cap).astype(np.int32),
            "b": rng.integers(0, 9, cap).astype(np.int32),
            "v": rng.normal(size=cap).astype(np.float32)}
    return cols, rng.random(cap) < 0.6, rng


RELATION_OPS = {
    "select": lambda R, rng, xp: R.select(("v", "a")),
    "rename": lambda R, rng, xp: R.rename({"a": "x", "v": "p"}),
    "filter": lambda R, rng, xp: R.filter(
        xp(rng.random(R.capacity) < 0.5)),
    "gather": lambda R, rng, xp: R.gather(
        xp(rng.integers(0, R.capacity, 17).astype(np.int64)),
        xp(rng.random(17) < 0.7)),
    "compact": lambda R, rng, xp: R.compact(),
    "compact_shrink": lambda R, rng, xp: R.compact(5),
    "compact_grow": lambda R, rng, xp: R.compact(40),
}


@pytest.mark.parametrize("op", sorted(RELATION_OPS))
@pytest.mark.parametrize("seed", [0, 1])
def test_relation_op_matches_jax(op, seed):
    cols, valid, _ = sample(seed)
    j, t = both(cols, valid)
    fn = RELATION_OPS[op]
    want = fn(j, np.random.default_rng(seed + 100), jnp.asarray)
    got = fn(t, np.random.default_rng(seed + 100), torch.as_tensor)
    assert_same(want, got)
    assert int(got.count()) == int(want.count())
    assert got.to_tuple_set() == want.to_tuple_set()


def test_relation_from_arrays_empty_concat_flatten():
    a = np.array([3, 1, 2], np.int32)
    v = np.array([0.5, 1.5, 2.5], np.float32)
    j = jrel.Relation.from_arrays(5, a=jnp.asarray(a), v=jnp.asarray(v))
    t = trel.Relation.from_arrays(5, a=torch.as_tensor(a),
                                  v=torch.as_tensor(v))
    assert_same(j, t)
    assert t.capacity == 5 and t.names == ("a", "v")
    np.testing.assert_array_equal(t.col("a").numpy(), np.asarray(j.col("a")))
    for k in ("a", "v"):
        np.testing.assert_array_equal(t.to_numpy()[k], j.to_numpy()[k])
    with pytest.raises(ValueError):
        trel.Relation.from_arrays(2, a=torch.as_tensor(a))

    e_j = jrel.Relation.empty(4, {"a": jnp.int32, "v": jnp.float32})
    e_t = trel.Relation.empty(4, {"a": torch.int32, "v": torch.float32},
                              device="cpu")
    assert_same(e_j, e_t)
    assert e_t.to_tuple_set() == set()

    assert_same(jrel.concat([j, e_j, j]), trel.concat([t, e_t, t]))

    # flatten_leading collapses the (K, cap) axes in front of the
    # capacity: the reference's per-device (K, cap) -> (K·cap,).
    cols, valid, _ = sample(4, cap=3 * 8)
    grid_cols = {n: c.reshape(3, 8) for n, c in cols.items()}
    jb, tb = both(grid_cols, valid.reshape(3, 8))
    assert_same(jrel.flatten_leading(jb), trel.flatten_leading(tb))
    # Batched: (*grid, K, cap) -> (*grid, K·cap), one device at a time
    # equal to the reference.
    cols, valid, _ = sample(5, cap=2 * 3 * 4)
    g_cols = {n: c.reshape(2, 3, 4) for n, c in cols.items()}
    tg = trel.flatten_leading(
        interop.relation_from_numpy(g_cols, valid.reshape(2, 3, 4), "cpu"))
    for d in range(2):
        jd, _ = both({n: c[d] for n, c in g_cols.items()},
                     valid.reshape(2, 3, 4)[d])
        want = jrel.flatten_leading(jd)
        got = trel.Relation({n: c[d] for n, c in tg.cols.items()},
                            tg.valid[d])
        assert_same(want, got)


def test_relation_ops_batched_over_leading_axes():
    """A (2, 3, cap) relation: every batched op equals the reference
    applied to each leading index."""
    rng = np.random.default_rng(9)
    cap = 10
    cols = {"a": rng.integers(0, 4, (2, 3, cap)).astype(np.int32),
            "v": rng.normal(size=(2, 3, cap)).astype(np.float32)}
    valid = rng.random((2, 3, cap)) < 0.5
    t = interop.relation_from_numpy(cols, valid, "cpu")
    idx = rng.integers(0, cap, (2, 3, 7)).astype(np.int64)
    take = rng.random((2, 3, 7)) < 0.8
    got_c = t.compact(6)
    got_g = t.gather(torch.as_tensor(idx), torch.as_tensor(take))
    np.testing.assert_array_equal(t.count().numpy(), valid.sum(-1))
    for i in range(2):
        for k in range(3):
            j, _ = both({n: c[i, k] for n, c in cols.items()}, valid[i, k])
            for want, got in ((j.compact(6), got_c),
                              (j.gather(jnp.asarray(idx[i, k]),
                                        jnp.asarray(take[i, k])), got_g)):
                assert_same(want, trel.Relation(
                    {n: c[i, k] for n, c in got.cols.items()},
                    got.valid[i, k]))


# ---------------------------------------------------------------------------
# Configuration and interop
# ---------------------------------------------------------------------------

def test_key_dtype_config_matches_jax():
    from repro import config as jcfg
    assert config.key_dtype_name() == jcfg.key_dtype_name() == "int32"
    assert config.default_key_dtype() == torch.int32
    assert not config.x64_enabled()


def test_entry_points_default_to_the_gpu():
    """With no GPU an entry point raises rather than running on the
    CPU; ``device="cpu"`` is the explicit opt-in."""
    from repro_torch.core import ChainQuery, chain_edge_inputs, edge_relation
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    src = np.array([0, 1, 2], np.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        edge_relation(src, src)
    with pytest.raises(RuntimeError, match="CUDA"):
        chain_edge_inputs(ChainQuery.three_way(), [(src, src)] * 3, (2, 2))
    rels = chain_edge_inputs(ChainQuery.three_way(), [(src, src)] * 3,
                             (2, 2), device="cpu")
    assert rels[0].device.type == "cpu" and rels[0].valid.shape == (2, 2, 1)


def test_interop_round_trip_and_caps():
    from repro.core import ChainCaps as JCaps
    cols, valid, _ = sample(7, cap=12)
    grid_cols = {n: c.reshape(2, 2, 3) for n, c in cols.items()}
    t = interop.relation_from_numpy(grid_cols, valid.reshape(2, 2, 3), "cpu")
    back, back_valid = interop.relation_to_numpy(t)
    np.testing.assert_array_equal(back_valid, valid.reshape(2, 2, 3))
    for n, c in grid_cols.items():
        np.testing.assert_array_equal(back[n], c)
    jc = JCaps(recv=5, mid=7, out=9, local=3, agg=2, join=11)
    tc = interop.caps_from_fields(**dataclasses.asdict(jc))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


# ---------------------------------------------------------------------------
# Independence from JAX and the JAX package
# ---------------------------------------------------------------------------

def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import repro_torch, repro_torch.core, repro_torch.interop\n"
            "import repro_torch.kernels.ops, repro_torch.kernels.fused_join\n"
            "import repro_torch.data.graphs\n"
            "assert not any(k == 'jax' or k.startswith('jax.') "
            "for k, v in sys.modules.items() if v is not None)\n"
            "print('IMPORT_OK')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "IMPORT_OK" in res.stdout
