"""The exchange collectives of the partitioned BFS on 3 gloo ranks (CPU).

One spawn (`parallel.ranks.run_ranks`) runs the three helpers of
`parallel.collectives` with inputs that differ by rank: the flag OR (an
int32 sum, then > 0), the bitmap OR with a word whose bit 31 is set (the
words travel as their int32 view), and the min with INT_MAX. Every rank
must get the same result, equal to numpy's on the stacked inputs, and
keep its inputs as they were. On the card (`cuda`-marked, skipped
elsewhere) one NCCL rank runs the helpers' NCCL forms (the bitmap OR as
an all-gather and fold), which must return their inputs.
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


def collective_rank(rank, group, device):
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
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return ranks.run_ranks(collective_rank, N,
                           str(tmp_path_factory.mktemp("rendezvous")),
                           device="cpu", timeout=120)


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
