"""The port's nearest-neighbour search (glim_tpu_torch/ops/nn_search.py)
against the JAX package's Pallas kernel and XLA kNN.

Inputs are made with numpy from a seed and handed to both packages. The
Pallas kernel runs in interpret mode, as tests/test_pallas_knn.py runs it.
Tolerances: indices are compared exactly wherever the runner-up target is
more than 1e-4 * max(1, d2) farther (otherwise f32 rounding of the distance
expansion may legitimately flip the winner); d2 at atol 1e-3, the
expansion's cancellation error at |q|, |t| ~ 20 m (|q|^2 ~ 1e3, f32 eps
~ 1e-7 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from glim_tpu.ops.knn import knn_search
from glim_tpu.ops.pallas_knn import nn_search_pallas
from glim_tpu_torch.ops import nn_search as t_nn
from glim_tpu_torch.ops.nn_search import launch_geometry, nn_search, nn_search_plain

D2_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _port_env():
    torch.set_num_threads(1)
    yield
    from glim_tpu_torch.utils.callbacks import CallbackSlot
    CallbackSlot.clear_all()


def _case(seed, Q, N, q_valid=None, t_valid=None, scale=20.0):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-scale, scale, (Q, 3)).astype(np.float32)
    t = rng.uniform(-scale, scale, (N, 3)).astype(np.float32)
    qm = np.ones(Q, bool) if q_valid is None else q_valid
    tm = np.ones(N, bool) if t_valid is None else t_valid
    return q, qm, t, tm


def _plain(q, qm, t, tm):
    idx, d2 = nn_search_plain(torch.from_numpy(q), torch.from_numpy(qm),
                              torch.from_numpy(t), torch.from_numpy(tm))
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    return idx.numpy(), d2.numpy()


def _decisive(q, qm, t, tm):
    """Queries whose runner-up is more than 1e-4 * max(1, d2) farther (f64)."""
    D = ((q[:, None, :].astype(np.float64) - t[None]) ** 2).sum(-1)
    D[:, ~tm] = np.inf
    two = np.sort(D, axis=1)[:, :2]
    return qm & (two[:, 1] - two[:, 0] > 1e-4 * np.maximum(1.0, two[:, 0]))


def test_plain_matches_pallas_interpret():
    Q, N = 512, 2048
    q, qm, t, tm = _case(0, Q, N, np.arange(Q) < Q - 50, np.arange(N) % 7 != 3)
    i_j, d_j = nn_search_pallas(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(t),
                                jnp.asarray(tm), interpret=True)
    i_t, d_t = _plain(q, qm, t, tm)
    dec = _decisive(q, qm, t, tm)
    assert dec.sum() > 0.9 * qm.sum()
    np.testing.assert_array_equal(i_t[dec], np.asarray(i_j)[dec])
    np.testing.assert_allclose(d_t[qm], np.asarray(d_j)[qm], atol=D2_ATOL)
    # Invalid queries: (0, +inf), as the Pallas wrapper returns them.
    assert (i_t[~qm] == 0).all() and np.isinf(d_t[~qm]).all()
    np.testing.assert_array_equal(i_t[~qm], np.asarray(i_j)[~qm])


@pytest.mark.parametrize("seed,q_keep,t_keep", [(1, 1.0, 1.0), (2, 0.8, 0.7),
                                                (3, 0.5, 0.2)])
def test_plain_matches_knn_search_ragged(seed, q_keep, t_keep):
    """Ragged Q=100, N=300 (no tile multiples) with masked lanes."""
    rng = np.random.default_rng(100 + seed)
    qm = rng.uniform(size=100) < q_keep
    tm = rng.uniform(size=300) < t_keep
    q, qm, t, tm = _case(seed, 100, 300, qm, tm, scale=5.0)
    i_j, d_j = knn_search(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(t),
                          jnp.asarray(tm), k=1)
    i_t, d_t = _plain(q, qm, t, tm)
    dec = _decisive(q, qm, t, tm)
    np.testing.assert_array_equal(i_t[dec], np.asarray(i_j)[dec, 0])
    np.testing.assert_allclose(d_t[qm], np.asarray(d_j)[qm, 0], atol=D2_ATOL)
    assert np.isinf(d_t[~qm]).all() and (i_t[~qm] == 0).all()


def test_tie_goes_to_lowest_index():
    """Duplicate targets: the lowest index wins, in both packages."""
    q, qm, t, tm = _case(4, 64, 512)
    t[300:364] = t[10:74]
    q[:] = t[10:74] + np.float32(1e-3)
    i_t, d_t = _plain(q, qm, t, tm)
    np.testing.assert_array_equal(i_t, np.arange(10, 74))
    i_j, _ = nn_search_pallas(jnp.asarray(np.pad(q, ((0, 256 - 64), (0, 0)))),
                              jnp.asarray(np.pad(qm, (0, 256 - 64))),
                              jnp.asarray(np.pad(t, ((0, 2048 - 512), (0, 0)))),
                              jnp.asarray(np.pad(tm, (0, 2048 - 512))),
                              interpret=True)
    np.testing.assert_array_equal(np.asarray(i_j)[:64], i_t)


def test_empty_targets_and_all_masked():
    q, qm, t, tm = _case(5, 10, 20)
    i_t, d_t = _plain(q, qm, t[:0], tm[:0])
    assert (i_t == 0).all() and np.isinf(d_t).all()
    i_t, d_t = _plain(q, qm, t, np.zeros(20, bool))
    assert (i_t == 0).all() and np.isinf(d_t).all()


def test_wrapper_routes_cpu_tensors_to_plain_version():
    q, qm, t, tm = _case(6, 100, 300)
    before = nn_search.kernel_launches
    args = [torch.from_numpy(a) for a in (q, qm, t, tm)]
    i_w, d_w = nn_search(*args)
    i_p, d_p = nn_search_plain(*args)
    assert torch.equal(i_w, i_p) and torch.equal(d_w, d_p)
    assert nn_search.kernel_launches == before      # no kernel launched


def test_wrapper_rejects_other_devices():
    """No fallback: tensors that are neither on the CPU nor on a CUDA device
    raise instead of being routed somewhere else."""
    q = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        nn_search(q, torch.ones(4, dtype=torch.bool, device="meta"),
                  q, torch.ones(4, dtype=torch.bool, device="meta"))


H100_SMS = 132


@pytest.mark.parametrize("Q,N", [(16384, 131072), (4096, 131072)])
def test_launch_geometry_fills_the_card_at_main_path_shapes(Q, N):
    """Both main-path shapes put at least two search blocks on every SM;
    the splits are whole tiles that cover N, none of them empty."""
    q_blocks, splits, split_len = launch_geometry(Q, N, H100_SMS)
    assert q_blocks * splits >= 2 * H100_SMS
    assert q_blocks == -(-Q // t_nn.QUERIES_PER_BLOCK)
    assert split_len % t_nn.TARGET_TILE == 0
    assert splits * split_len >= N > (splits - 1) * split_len


@pytest.mark.parametrize("Q,N", [(1, 1), (1, 131072), (16384, 1), (5, 0), (4096, 0),
                                 (1000, 100), (1000, t_nn.TARGET_TILE - 1),
                                 (1000, t_nn.TARGET_TILE + 1), (2**20, 131072)])
def test_launch_geometry_edge_cases(Q, N):
    """Q=1, N=1, N=0 (one empty split), N under one tile, a huge Q (one
    split): S >= 1, whole tiles, and the splits cover N."""
    q_blocks, splits, split_len = launch_geometry(Q, N, H100_SMS)
    assert q_blocks >= 1 and splits >= 1 and split_len >= t_nn.TARGET_TILE
    assert split_len % t_nn.TARGET_TILE == 0
    assert splits * split_len >= N
    if N <= t_nn.TARGET_TILE:
        assert splits == 1
    else:
        assert (splits - 1) * split_len < N
    if Q >= t_nn.BLOCKS_PER_SM * H100_SMS * t_nn.QUERIES_PER_BLOCK:
        assert splits == 1


def _split_merge_model(q, qm, t, tm, split_len):
    """The kernel's split-and-merge in plain torch: the plain search on each
    target range, then the partials merged in split order with a strict
    '<', so a tie keeps the earlier split (the lower index)."""
    args = [torch.from_numpy(a) for a in (q, qm, t, tm)]
    idx = torch.zeros(len(q), dtype=torch.int32)
    d2 = torch.full((len(q),), float("inf"))
    for begin in range(0, max(len(t), 1), split_len):
        sl = slice(begin, begin + split_len)
        i_s, d_s = nn_search_plain(args[0], args[1], args[2][sl], args[3][sl])
        take = d_s < d2
        idx = torch.where(take, i_s + begin, idx)
        d2 = torch.where(take, d_s, d2)
    return idx.numpy(), d2.numpy()


def test_split_merge_model_keeps_the_lowest_index():
    """Duplicates on both sides of a split boundary, and a split whose
    targets are all masked: the split-and-merge model agrees with the
    unsplit plain version and with the Pallas kernel (interpret mode)."""
    Q, N, split_len = 256, 4096, 1024
    q, qm, t, tm = _case(8, Q, N, np.arange(Q) % 11 != 5, np.arange(N) % 5 != 2)
    lo = np.arange(1024 - 48, 1024)                 # left of the boundary at 1024
    t[1024:1024 + 48] = t[lo]
    tm[lo] = tm[1024:1024 + 48] = True
    q[:48] = t[lo] + np.float32(1e-3)
    qm[:48] = True
    tm[2048:3072] = False                           # the third split holds no valid target
    q[48:64] = t[2048:2064] + np.float32(1e-3)      # nearest to a masked target
    i_m, d_m = _split_merge_model(q, qm, t, tm, split_len)
    i_p, d_p = _plain(q, qm, t, tm)
    np.testing.assert_array_equal(i_m[:48], lo)
    np.testing.assert_array_equal(i_m, i_p)
    np.testing.assert_allclose(d_m, d_p, atol=D2_ATOL)
    assert not np.isin(i_m[qm], np.arange(2048, 3072)).any()
    i_j, d_j = nn_search_pallas(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(t),
                                jnp.asarray(tm), interpret=True)
    dec = _decisive(q, qm, t, tm)
    dec[:48] = True                                 # exact duplicates: the lowest index
    np.testing.assert_array_equal(i_m[dec], np.asarray(i_j)[dec])
    np.testing.assert_allclose(d_m[qm], np.asarray(d_j)[qm], atol=D2_ATOL)
    assert (i_m[~qm] == 0).all() and np.isinf(d_m[~qm]).all()


def test_split_merge_model_with_no_valid_target():
    """Every split masked: (0, +inf) for every query, as the unsplit search."""
    q, qm, t, tm = _case(9, 40, 3000, t_valid=np.zeros(3000, bool))
    i_m, d_m = _split_merge_model(q, qm, t, tm, 512)
    assert (i_m == 0).all() and np.isinf(d_m).all()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the nn_search kernel has no CPU mode)")
    return torch.device("cuda")


def _duplicates(case, q, qm, t, tm):
    """Exact duplicate targets (within 2.5 m of the origin, where a query on a
    target keeps the plain version's cancellation error under D2_ATOL) and
    the rows that must get the lowest copy: across the middle split
    boundary that the launch geometry picks ("split"), or in one thread's
    query rows, inside one chunk and in the next ("rows")."""
    if case == "split":
        _, splits, split_len = launch_geometry(len(q), len(t), t_nn._sm_count(0))
        b = split_len * (splits // 2)
        lo = np.arange(b - 64, b)
        t[lo] *= np.float32(0.25)
        t[b:b + 64] = t[lo]
        tm[lo] = tm[b:b + 64] = True
        rows = np.arange(64)
        want = lo
    else:
        rows = (3 * t_nn.QUERIES_PER_BLOCK + 5
                + t_nn.QUERY_THREADS * np.arange(t_nn.QUERY_ROWS))
        a = 70000 + 16 * np.arange(t_nn.QUERY_ROWS)
        t[a] *= np.float32(0.25)
        for off in (0, 1, 3, 11):
            t[a + off] = t[a]
            tm[a + off] = True
        want = a.copy()
        want[-1] = a[0]
    q[rows] = t[want]
    qm[rows] = True
    return rows, want


@pytest.mark.gpu
@pytest.mark.parametrize("Q,N,dups", [(16384, 131072, None), (4096, 131072, None),
                                      (1000, 3001, None), (1, 1, None),
                                      (16384, 131072, "split"), (16384, 131072, "rows")])
def test_cuda_kernel_matches_plain(cuda, Q, N, dups):
    rng = np.random.default_rng(Q + N)
    q, qm, t, tm = _case(7, Q, N, rng.uniform(size=Q) > 0.05, rng.uniform(size=N) > 0.3)
    rows = _duplicates(dups, q, qm, t, tm) if dups else None
    args = [torch.from_numpy(a).to(cuda) for a in (q, qm, t, tm)]
    before = nn_search.kernel_launches
    i_k, d_k = nn_search(*args)
    torch.cuda.synchronize()
    assert nn_search.kernel_launches == before + 1
    i_p, d_p = nn_search_plain(*args)
    qm_d = args[1]
    # d2 at D2_ATOL (the expansion's cancellation at |q|, |t| ~ 20 m; kernel
    # and plain version round in another order); no valid target: both +inf.
    close = torch.where(torch.isinf(d_p), d_k == d_p, (d_k - d_p).abs() <= D2_ATOL)
    assert bool(close[qm_d].all())
    same = (i_k == i_p) | ~qm_d
    assert float(same.float().mean()) > 0.999
    assert bool((i_k[~qm_d] == 0).all()) and bool(torch.isinf(d_k[~qm_d]).all())
    if rows is not None:
        np.testing.assert_array_equal(i_k.cpu().numpy()[rows[0]], rows[1])


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_bad_input(cuda):
    q = torch.zeros(8, 3, device=cuda)
    m = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        nn_search(q.double(), m, q, m)
    with pytest.raises(ValueError, match="contiguous"):
        nn_search(torch.zeros(3, 8, device=cuda).T, m, q, m)
    with pytest.raises(ValueError, match="on cpu"):
        nn_search(q, m, q.cpu(), m)
