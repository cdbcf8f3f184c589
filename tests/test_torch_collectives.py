"""The exchange collectives of the partitioned BFS on 3 gloo ranks (CPU).

One spawn (`parallel.ranks.run_ranks`) runs the three helpers of
`parallel.collectives` with inputs that differ by rank: the flag OR (an
int32 sum, then > 0), the bitmap OR with a word whose bit 31 is set (the
words travel as their int32 view), and the min with INT_MAX. Every rank
must get the same result, equal to numpy's on the stacked inputs, and
keep its inputs as they were. On the card (`cuda`-marked, skipped
elsewhere) one NCCL rank runs the helpers' NCCL forms (the bitmap OR as
an all-gather and fold), which must return their inputs.

The same spawn runs the int8 gradient compression: `compressed_psum` of a
gradient tree (fp32 and bf16 leaves) fed the JAX function's own draws
(`jax.random.uniform(fold_in(fold_in(PRNGKey(0), i), rank), shape)`,
made in the parent) equals the JAX `compressed_psum` vmapped over the
stacked rank inputs (`axis_name="d"`) bit for bit, and with its own
generators every element lies within the leaf's shared scale of the exact
mean. On one process: the rounding step fed the JAX draws gives the JAX
`quantize_int8` codes and scale and `dequantize_int8` bit for bit, and
the JAX test's round-trip bound and unbiasedness hold with the port's
generators.
"""
import numpy as np
import pytest
import torch

from repro_torch.parallel import collectives as C
from repro_torch.parallel import ranks

N = 3
INT_MAX = 2**31 - 1


def _inputs(rank):
    rng = np.random.default_rng(rank)
    flags = (rng.random(70) < 0.2).astype(np.uint8)
    words = rng.integers(0, 2**32, 5, dtype=np.uint64).astype(np.uint32)
    words[0] = np.uint32(1 << 31) if rank == 1 else np.uint32(1 << rank)
    x = rng.integers(-5, 100, 9).astype(np.int32)
    x[0] = INT_MAX
    x[1] = INT_MAX if rank else 3
    return flags, words, x


def _grads(rank):
    """A rank's gradient tree, as numpy fp32 (leaf "e" goes in as bf16)."""
    rng = np.random.default_rng(100 + rank)
    return {"w": rng.standard_normal((6, 11)).astype(np.float32) * (rank + 1),
            "b": rng.standard_normal(17).astype(np.float32) * 1e-3,
            "e": rng.standard_normal((4, 4, 3)).astype(np.float32)}


def _torch_grads(rank, device):
    g = {k: torch.from_numpy(v.copy()).to(device)
         for k, v in _grads(rank).items()}
    g["e"] = g["e"].to(torch.bfloat16)
    return g


def _as_numpy(tree):
    return {k: v.float().cpu().numpy() for k, v in tree.items()}


def collective_rank(rank, group, device, draws=None):
    flags, words, x = _inputs(rank)
    tf = torch.from_numpy(flags.copy()).to(device)
    tw = torch.from_numpy(words.view(np.int32).copy()).to(device).view(
        torch.uint32)
    tx = torch.from_numpy(x.copy()).to(device)
    out = dict(flags=C.or_allreduce_flags(tf, group).cpu().numpy(),
               words=C.or_allreduce_bitmap(tw, group).view(torch.int32)
               .cpu().numpy().view(np.uint32),
               min=C.min_allreduce(tx, group).cpu().numpy())
    out["kept"] = (np.array_equal(tf.cpu().numpy(), flags)
                   and np.array_equal(tw.view(torch.int32).cpu().numpy(),
                                      words.view(np.int32))
                   and np.array_equal(tx.cpu().numpy(), x))
    grads = _torch_grads(rank, device)
    out["compressed"] = _as_numpy(C.compressed_psum(grads, group, seed=7))
    if draws is not None:
        mine = draws[rank]
        out["compressed_fed"] = _as_numpy(C.compressed_psum(
            grads, group, draws=lambda i, leaf: torch.from_numpy(
                mine[i].copy()).to(leaf.device)))
    return out


def _jax_leaves(rank):
    import jax.numpy as jnp
    g = {k: jnp.asarray(v) for k, v in _grads(rank).items()}
    g["e"] = g["e"].astype(jnp.bfloat16)
    return g


@pytest.fixture(scope="module")
def jax_compressed():
    """The JAX `compressed_psum` over the N stacked rank trees (vmapped on
    axis "d"), and each rank's draws for leaf i (sorted keys, as
    `jax.tree.flatten` orders a dict)."""
    import jax
    import jax.numpy as jnp
    from repro.parallel.collectives import compressed_psum
    key = jax.random.PRNGKey(0)
    trees = [_jax_leaves(r) for r in range(N)]
    stacked = {k: jnp.stack([t[k] for t in trees]) for k in trees[0]}
    want = jax.vmap(lambda t: compressed_psum(t, "d", key),
                    axis_name="d")(stacked)
    draws = [[np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(key, i), r), trees[r][k].shape))
        for i, k in enumerate(sorted(trees[r]))] for r in range(N)]
    return ({k: np.asarray(v.astype(jnp.float32)) for k, v in want.items()},
            draws)


@pytest.fixture(scope="module")
def results(tmp_path_factory, jax_compressed):
    return ranks.run_ranks(collective_rank, N,
                           str(tmp_path_factory.mktemp("rendezvous")),
                           args=(jax_compressed[1],), device="cpu",
                           timeout=120)


def _want():
    ins = [_inputs(r) for r in range(N)]
    return dict(
        flags=(np.stack([i[0] for i in ins]).astype(np.int32).sum(0) > 0
               ).astype(np.uint8),
        words=np.bitwise_or.reduce(np.stack([i[1] for i in ins]), axis=0),
        min=np.stack([i[2] for i in ins]).min(0))


@pytest.mark.parametrize("what", ["flags", "words", "min"])
def test_collective_matches_numpy(results, what):
    want = _want()[what]
    for rank, out in enumerate(results):
        assert out[what].dtype == want.dtype
        np.testing.assert_array_equal(out[what], want, err_msg=f"rank {rank}")
    if what == "words":
        assert want[0] == np.uint32((1 << 31) | 1 | 4)
    if what == "min":
        assert want[0] == INT_MAX and want[1] == 3


def test_collectives_keep_their_inputs(results):
    assert all(out["kept"] for out in results)


@pytest.mark.parametrize("leaf", ["b", "e", "w"])
def test_compressed_psum_fed_the_jax_draws_is_the_jax_mean(
        results, jax_compressed, leaf):
    want = jax_compressed[0][leaf][0]
    for rank, out in enumerate(results):
        got = out["compressed_fed"][leaf]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(jax_compressed[0][leaf][rank], want)


@pytest.mark.parametrize("leaf", ["b", "e", "w"])
def test_compressed_psum_within_the_shared_scale(results, leaf):
    trees = [_torch_grads(r, "cpu") for r in range(N)]
    scale = max(float(C.int8_scale(t[leaf])) for t in trees)
    exact = np.mean([t[leaf].double().numpy() for t in trees], axis=0)
    # a bf16 leaf's mean is rounded to bf16 once more (half an ulp)
    ulp = 2.0 ** -8 if leaf == "e" else 0.0
    for rank, out in enumerate(results):
        got = out["compressed"][leaf]
        np.testing.assert_array_equal(got, results[0]["compressed"][leaf])
        err = np.abs(got - exact)
        assert (err <= scale * (1 + 1e-6) + ulp * np.abs(exact)).all(), \
            (rank, float(err.max()), scale)
    # its own generators round otherwise than the fed draws
    assert not np.array_equal(results[0]["compressed"][leaf],
                              results[0]["compressed_fed"][leaf])


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 12345])
def test_rounding_fed_the_jax_draws_is_quantize_int8(seed):
    import jax
    import jax.numpy as jnp
    from repro.parallel.collectives import dequantize_int8, quantize_int8
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(257).astype(np.float32) * rng.random() * 10
    key = jax.random.PRNGKey(seed)
    q, scale = quantize_int8(jnp.asarray(x), key)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, x.shape)).copy())
    tx = torch.from_numpy(x)
    tscale = C.int8_scale(tx)
    tq = C.stochastic_round_int8(tx, tscale, u)
    assert tq.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
    assert tscale.numpy().tobytes() == np.asarray(scale).tobytes()
    np.testing.assert_array_equal(C.dequantize_int8(tq, tscale).numpy(),
                                  np.asarray(dequantize_int8(q, scale)))


@pytest.mark.parametrize("seed", [0, 1, 7, 99, 2**31 - 1])
def test_quantize_roundtrip_bounded(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(64).astype(np.float32)
                         * rng.random() * 10)
    q, scale = C.quantize_int8(x, torch.Generator().manual_seed(seed))
    err = (C.dequantize_int8(q, scale) - x).abs()
    assert bool((err <= float(scale) + 1e-6).all())


@pytest.mark.parametrize("spread", [False, True])
def test_quantize_unbiased(spread):
    x = torch.full((2000,), 0.3141592)
    if spread:                  # values off the grid, not one constant
        x = torch.from_numpy(np.random.default_rng(5).uniform(
            -1, 1, 2000).astype(np.float32))
    qs = [C.dequantize_int8(*C.quantize_int8(
        x, torch.Generator().manual_seed(i))) for i in range(64)]
    mean = float(torch.stack(qs).double().mean())
    assert abs(mean - float(x.double().mean())) < 2e-4


def test_rank_failure_raises_with_its_traceback(tmp_path):
    with pytest.raises(RuntimeError,
                       match=r"rank 1 failed:[\s\S]*rank one gives up"):
        ranks.run_ranks(failing_rank, 2, str(tmp_path), device="cpu",
                        timeout=60)


def failing_rank(rank, group, device):
    if rank == 1:
        raise KeyError("rank one gives up")
    torch.distributed.barrier(group)       # rank 0 waits; it is killed


@pytest.mark.cuda
def test_nccl_forms_on_one_rank(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the GPU host)")
    (out,) = ranks.run_ranks(collective_rank, 1, str(tmp_path),
                             backend="nccl", timeout=300)
    flags, words, x = _inputs(0)
    np.testing.assert_array_equal(out["flags"], (flags > 0).astype(np.uint8))
    np.testing.assert_array_equal(out["words"], words)
    np.testing.assert_array_equal(out["min"], x)
    assert out["kept"]
