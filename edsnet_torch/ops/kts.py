"""KTS kernel temporal segmentation (change-point detection).

Counterpart of edsnet_tpu/ops/kts.py.

Host path (``cpd_nonlin`` / ``cpd_auto``): the float64 numpy scatter matrix
and the DP of the native library (``native.py``: ``eds_kts_dp``), or its
numpy twin ``_kts_dp_numpy`` when the library is unavailable.  ``cpd_auto``
runs the DP once, at the largest number of change points, and selects the
model from that one table (the rows I[k] depend only on I[k - 1]).

Device path (``cpd_auto_device``, ``--device-kts``): the same segmentation
in float32 on an explicit ``torch.device``: ``calc_scatters_device``, the DP
``kts_dp_device`` over a bucket-padded [L + 1, L + 1] table for L - 1 steps
(one add and one fused ``torch.min(dim=0)`` per step; the row bound k * lmin
is a slice, the rest of the mask is built once), the penalised model
selection and ``kts_backtrack_device``.  Calls whose n^2 * max|K| exceeds
the float32 bound take the float64 host path instead, and are counted in
``cpd_auto_device.fallbacks``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from edsnet_torch.native import load as _native_load

_INF64 = 1e101
_INF32 = 1e30  # float32-safe sentinel (scatter magnitudes are <= n * max|K|)


# ---------------------------------------------------------------------------
# scatter matrix
# ---------------------------------------------------------------------------

def calc_scatters(K: np.ndarray) -> np.ndarray:
    """scatters[i, j] = within-segment scatter of frames [i..j], float64.

    For a kernel matrix K the scatter of segment [i..j] in feature space is
    sum_{t=i..j} K[t,t] - (sum_{s,t=i..j} K[s,t]) / (j - i + 1); both sums
    come from prefix tables (the cumulative trace and the 2-D cumulative
    block sum, four corners per segment).  0 below the diagonal."""
    K = np.asarray(K, dtype=np.float64)
    n = K.shape[0]
    trace_csum = np.concatenate([[0.0], np.cumsum(np.diag(K))])
    block_csum = np.zeros((n + 1, n + 1))
    block_csum[1:, 1:] = np.cumsum(np.cumsum(K, 0), 1)

    i = np.arange(n).reshape((-1, 1))
    j = np.arange(n).reshape((1, -1))
    seg_trace = trace_csum[1:][None, :] - trace_csum[:-1][:, None]
    seg_block = (block_csum[1:, 1:].diagonal()[None, :]     # corner (j+1,j+1)
                 + block_csum.diagonal()[:-1][:, None]      # corner (i,i)
                 - block_csum[1:, :-1].T                    # corner (j+1,i)
                 - block_csum[:-1, 1:])                     # corner (i,j+1)
    # guard the (empty) j == i-1 cells against 0/0; masked to 0 below
    seg_len = (j - i + 1).astype(np.float64) + (j == i - 1)
    scatters = seg_trace - seg_block / seg_len
    scatters[j < i] = 0
    return scatters


def calc_scatters_device(K: torch.Tensor) -> torch.Tensor:
    """float32 twin of :func:`calc_scatters` on ``K``'s device (the same
    identity)."""
    K = K.to(torch.float32)
    n = K.shape[0]
    zero = K.new_zeros(1)
    trace_csum = torch.cat([zero, torch.cumsum(torch.diagonal(K), 0)])
    block_csum = K.new_zeros(n + 1, n + 1)
    block_csum[1:, 1:] = torch.cumsum(torch.cumsum(K, 0), 1)
    diag = torch.diagonal(block_csum)

    i = torch.arange(n, device=K.device)[:, None]
    j = torch.arange(n, device=K.device)[None, :]
    seg_trace = trace_csum[1:][None, :] - trace_csum[:-1][:, None]
    seg_block = (diag[1:][None, :] + diag[:-1][:, None]
                 - block_csum[1:, :-1].T - block_csum[:-1, 1:])
    seg_len = (j - i + 1).to(torch.float32) + (j == i - 1).to(torch.float32)
    return torch.where(j < i, 0.0, seg_trace - seg_block / seg_len)


# ---------------------------------------------------------------------------
# host DP
# ---------------------------------------------------------------------------

def _kts_dp_numpy(J: np.ndarray, m: int, lmin: int, lmax: int,
                  backtrack: bool) -> Tuple[np.ndarray, np.ndarray]:
    """numpy twin of the native DP -> (scores [m + 1], path)."""
    n = J.shape[0]
    I = np.full((m + 1, n + 1), _INF64)
    upto = min(lmax, n + 1)
    if upto > lmin:
        I[0, lmin:upto] = J[0, lmin - 1:upto - 1]
    path = np.zeros((m + 1, n + 1), dtype=np.int32)

    t = np.arange(n + 1)[:, None]
    l = np.arange(n + 1)[None, :]
    for k in range(1, m + 1):
        tmin = np.maximum(k * lmin, l - lmax)
        tmax = l - lmin + 1
        valid = ((t >= tmin) & (t < tmax) & (l >= (k + 1) * lmin) & (t < n)
                 & (l >= 1))
        Jmat = J[np.clip(t, 0, n - 1), np.clip(l - 1, 0, n - 1)]
        C = np.where(valid, Jmat + I[k - 1][:n + 1, None], _INF64)
        I[k] = C.min(axis=0)
        if backtrack:
            path[k] = C.argmin(axis=0)
    return I[:, n].copy(), path


def _backtrack(path: np.ndarray, m: int, n: int) -> np.ndarray:
    cps = np.zeros(m, dtype=int)
    cur = n
    for k in range(m, 0, -1):
        cps[k - 1] = path[k, cur]
        cur = cps[k - 1]
    return cps


def _kts_dp_host(J: np.ndarray, m: int, lmin: int, lmax: int,
                 backtrack: bool):
    lib = _native_load()
    if lib is not None:
        return lib.kts_dp(J, m, lmin, min(lmax, J.shape[0] + 1), backtrack)
    return _kts_dp_numpy(J, m, lmin, lmax, backtrack)


def cpd_nonlin(K: np.ndarray, ncp: int, lmin: int = 1, lmax: int = 100000,
               backtrack: bool = True, verbose: bool = False,
               out_scatters=None) -> Tuple[np.ndarray, np.ndarray]:
    """Change points of the [n, n] kernel ``K`` at exactly ``ncp`` of them,
    segments of ``lmin`` to ``lmax`` frames -> (cps [ncp], scores
    [ncp + 1], inf where infeasible)."""
    m = int(ncp)
    n, n1 = K.shape
    assert n == n1, "Kernel matrix awaited."
    assert (m + 1) * lmin <= n <= (m + 1) * lmax
    assert 1 <= lmin <= lmax

    J = calc_scatters(K)
    if out_scatters is not None:
        out_scatters[0] = J
    scores, path = _kts_dp_host(J, m, lmin, lmax, backtrack)

    cps = _backtrack(path, m, n) if backtrack else np.zeros(m, dtype=int)
    scores = scores.copy()
    scores[scores > 1e99] = np.inf
    return cps, scores


def cpd_auto(K: np.ndarray, ncp: int, vmax: float, desc_rate: int = 1,
             **kwargs) -> Tuple[np.ndarray, np.ndarray]:
    """Change points with the number chosen by the penalised cost, at most
    ``ncp`` -> (cps, scores [m_best + 1]).  One backtrackable DP at ``ncp``
    serves the scoring and the backtrack."""
    m = int(ncp)
    n = K.shape[0]
    lmin = kwargs.get("lmin", 1)
    lmax = kwargs.get("lmax", 100000)
    assert (m + 1) * lmin <= n <= (m + 1) * lmax

    J = calc_scatters(K)
    scores, path = _kts_dp_host(J, m, lmin, lmax, True)

    N2 = n * desc_rate
    penalties = np.zeros(m + 1)
    ncps = np.arange(1, m + 1)
    if m >= 1:
        penalties[1:] = ((vmax * ncps / (2.0 * N2))
                         * (np.log(float(N2) / ncps) + 1))

    scores_inf = scores.copy()
    scores_inf[scores_inf > 1e99] = np.inf
    costs = scores_inf / float(n) + penalties
    m_best = int(np.argmin(costs))

    cps = _backtrack(path, m_best, n)
    return cps, scores_inf[:m_best + 1].copy()


# ---------------------------------------------------------------------------
# device DP
# ---------------------------------------------------------------------------

def kts_dp_device(J: torch.Tensor, n: int, m_max: int, lmin: int = 1,
                  lmax: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The KTS DP over a (padded) [L, L] float32 scatter matrix on its
    device, of which the first ``n`` rows and columns are real.

    -> (scores [m_max + 1]: the optimal objective with k change points,
    1e30 where infeasible; path [m_max + 1, L + 1] int64: the argmin of
    each step, the first index among equal minima, as JAX's ``argmin``).
    Step k reads I[k - 1] and the table Jmat[t, l] = J[t, l - 1] masked
    where a split at t is invalid for a segment ending at l; the bounds
    that do not depend on k are masked once, t >= k * lmin is the slice
    that the step's add reads, and l >= (k + 1) * lmin is written after
    the min, which writes the step's rows of I and of the path in place.
    The entries past ``n`` and the infeasible ones hold 1e30 or more, and
    no finite path reads them."""
    L = J.shape[0]
    device = J.device
    lmax_eff = min(lmax if lmax else L + 1, n + 1)
    l_ax = torch.arange(L + 1, device=device)
    t = l_ax[:, None]
    l = l_ax[None, :]
    Jmat = J[t.clamp(0, L - 1), (l - 1).clamp(0, L - 1)]
    valid = ((t >= l - lmax_eff) & (t < l - lmin + 1) & (t < n) & (l >= 1)
             & (l <= n))
    base = torch.where(valid, Jmat, _INF32)
    del Jmat, valid

    I_rows = torch.empty(m_max + 1, L + 1, dtype=torch.float32,
                         device=device)
    path = torch.zeros(m_max + 1, L + 1, dtype=torch.int64, device=device)
    I_rows[0] = torch.where((l_ax >= lmin) & (l_ax < lmax_eff)
                            & (l_ax <= n),
                            J[0, (l_ax - 1).clamp(0, L - 1)], _INF32)
    buf = torch.empty_like(base)
    for k in range(1, m_max + 1):
        lo = k * lmin
        if lo > L:          # no split position left
            I_rows[k:] = _INF32
            break
        C = torch.add(base[lo:], I_rows[k - 1, lo:, None],
                      out=buf[:L + 1 - lo])
        torch.min(C, dim=0, out=(I_rows[k], path[k]))
        I_rows[k, :(k + 1) * lmin] = _INF32
    path += (torch.arange(m_max + 1, device=device) * lmin
             ).clamp(max=L + 1)[:, None]
    scores = I_rows[:, n].clone()
    return scores, path


def kts_backtrack_device(path: torch.Tensor, m_best: int, n: int
                         ) -> torch.Tensor:
    """Change points of the best ``m_best`` from the DP's path table, on its
    device -> [m_best] int64."""
    cps = torch.zeros(m_best, dtype=torch.int64, device=path.device)
    cur = torch.tensor(n, device=path.device)
    for k in range(m_best, 0, -1):
        cur = path[k, cur]
        cps[k - 1] = cur
    return cps


# float32 bound of the device path: its change points equal the float64
# host's while n^2 * max|K| stays below ~1e8 (the scatter cumsums grow like
# n^2 * max|K|); half of that is the bound.  L2-normalised frame features
# (|K| <= 1) keep the device path exact to ~7,000 positions.
_DEVICE_F32_CRIT = 5e7


def cpd_auto_device(K: np.ndarray, ncp: int, vmax: float,
                    desc_rate: int = 1, lmin: int = 1,
                    lmax: Optional[int] = None, bucket_size: int = 64,
                    device: torch.device | str = "cuda"
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Device twin of ``cpd_auto`` -> (cps, scores [m_best + 1]).

    The kernel is zero-padded to a multiple of ``bucket_size`` and the DP
    runs L - 1 steps, so the result does not depend on the bucket.  ncp is
    clamped to n - 1 (and to n // lmin - 1); an ``lmax`` too small for any
    segmentation gives no change points.  Where n^2 * max|K| exceeds
    ``_DEVICE_F32_CRIT`` the float64 host ``cpd_auto`` answers instead, and
    ``cpd_auto_device.fallbacks`` counts it; ``cpd_auto_device.device_calls``
    counts the calls that ran on the device."""
    K = np.asarray(K)
    n = K.shape[0]
    ncp = min(int(ncp), n - 1)
    if lmin > 1:
        ncp = min(ncp, max(n // lmin - 1, 0))
    if lmax is not None and n > (ncp + 1) * lmax:
        # no feasible segmentation at any m <= ncp under lmax
        return np.zeros((0,), np.int64), np.asarray([np.inf])
    # the bound is read on the original values, before the float32 cast
    if n * n * float(np.abs(K).max(initial=0.0)) > _DEVICE_F32_CRIT:
        cpd_auto_device.fallbacks += 1
        kw = {} if lmax is None else {"lmax": lmax}
        return cpd_auto(np.asarray(K, np.float64), ncp, vmax,
                        desc_rate=desc_rate, lmin=lmin, **kw)
    cpd_auto_device.device_calls += 1
    L = max(bucket_size, -(-n // bucket_size) * bucket_size)
    K_pad = torch.zeros(L, L, dtype=torch.float32, device=device)
    K_pad[:n, :n] = torch.from_numpy(np.asarray(K, np.float32)).to(device)
    m_max = L - 1
    scores, path = kts_dp_device(calc_scatters_device(K_pad), n, m_max,
                                 lmin, lmax)

    n2 = torch.tensor(float(n * desc_rate), dtype=torch.float32,
                      device=device)
    k_ax = torch.arange(m_max + 1, dtype=torch.float32, device=device)
    pen = torch.where(k_ax > 0,
                      (torch.tensor(vmax, dtype=torch.float32) * k_ax
                       / (2.0 * n2))
                      * (torch.log(n2 / k_ax.clamp(min=1.0)) + 1.0), 0.0)
    costs = scores / float(n) + pen
    costs = torch.where(torch.arange(m_max + 1, device=device) <= ncp,
                        costs, torch.inf)
    costs = torch.where(scores >= _INF32 * 0.5, torch.inf, costs)
    m_best = int(torch.argmin(costs))
    cps = kts_backtrack_device(path, m_best, n).cpu().numpy()
    scores = scores[:m_best + 1].cpu().numpy().astype(np.float64)
    scores[scores > 1e29] = np.inf
    return cps, scores


cpd_auto_device.fallbacks = 0
cpd_auto_device.device_calls = 0
