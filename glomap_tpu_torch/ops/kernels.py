"""The port's CUDA kernels: wrappers, plain versions, counters.

Counterpart of glomap_tpu/ops/pallas_kernels.py, and of the JAX
package's chunk of RANSAC rounds (B8, `ransac_chunk`). Each kernel comes
in three parts:

  * a wrapper (`projection_resid_jac`, `gather`, `rowsum`,
    `pair_rowsum`, `gather_dot`, `huber_irls`, `sampson_score`,
    `ransac_chunk`) that takes the plain version for a
    CPU tensor and otherwise launches the CUDA kernel (`_*_cuda`) or
    raises -- there is no fallback;
  * the plain PyTorch version (`*_plain`), the reference the tests and
    chip_smoke.py hold the kernel against;
  * a launch counter in LAUNCHES, incremented only where the kernel is
    launched.

Layouts are the JAX package's: per-observation data as (k, O) row stacks
with the observation axis contiguous, so a thread per observation reads
and writes coalesced rows. Segment reductions read the CSR of their id
axis (`SegmentAxis`: ids, a stable argsort `perm`, `offsets`) and its
chunk plans, built once per solve: every segment is cut into chunks of a
fixed number of CSR entries, a chunk is one warp's (B3) or one block's
(B4) work item, and a segment's chunk partials are added in chunk order
by its last chunk to finish, in the same launch. The order of every sum
depends only on the segment's length and members, so the results are
deterministic and do not change when other segments come or go.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import torch

from glomap_tpu_torch.ops import _build

LAUNCHES = {"projection_resid_jac": 0, "gather": 0, "rowsum": 0,
            "pair_rowsum": 0, "gather_dot": 0, "huber": 0, "sampson": 0,
            "ransac": 0}
# the z-normalisation offset and denominator clamp of the Sampson error
SAMPSON_EPS = 1e-12
# CSR entries per chunk: one warp's work item in rowsum.cu (four
# observations a lane), one block's in pair_rowsum.cu
ROWSUM_CHUNK = 128
PAIR_CHUNK = 512
# gather.cu (gather_plan): where a launch reads its table (in place, or
# staged whole in each block's shared memory: tables of 2 to
# GATHER_WHOLE_ROWS rows of at least GATHER_WHOLE_K columns that fit
# GATHER_SMEM_BYTES), and the observations a thread writes with one store
# (4 for tables of at most 2 columns on axes of GATHER_WIDE_OBS or more, else
# 1); chosen from measurements on an H100 (PERF.md)
GATHER_DIRECT, GATHER_WHOLE = 0, 1
GATHER_WHOLE_ROWS = 128
GATHER_WHOLE_K = 16
GATHER_SMEM_BYTES = 32 << 10
GATHER_WIDE_OBS = 1 << 20


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------------------------
# id axes
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class ChunkPlan:
    """Segment s of an axis in nc_s = max(1, ceil(len_s / length)) chunks:
    chunk c holds CSR entries offsets[s] + c * length onward, at most
    `length` of them (an empty segment has one empty chunk, which writes
    its zeros). items (2, n_items) int32 lists (segment, chunk)
    chunk-major (every segment's chunk 0, then every chunk 1, ...),
    segments ascending within, so neighbouring work items read
    neighbouring segments at the same offset; chunk_base (n_seg + 1,)
    int32 gives each segment's first scratch slot, and chunk c of segment
    s has slot chunk_base[s] + c."""
    length: int
    items: torch.Tensor
    chunk_base: torch.Tensor

    @property
    def n_items(self) -> int:
        """Chunks, and scratch slots: one each."""
        return self.items.shape[1]

    @staticmethod
    def build(offsets: torch.Tensor, length: int) -> "ChunkPlan":
        """The plan of a CSR `offsets` (n_seg + 1,); one host read."""
        n_seg = offsets.shape[0] - 1
        lens = (offsets[1:] - offsets[:-1]).long()
        nc = torch.clamp((lens + length - 1) // length, min=1)
        base = torch.zeros(n_seg + 1, dtype=torch.int64, device=offsets.device)
        base[1:] = torch.cumsum(nc, 0)
        total = int(base[-1])
        seg = torch.repeat_interleave(
            torch.arange(n_seg, device=offsets.device), nc, output_size=total)
        chunk = torch.arange(total, device=offsets.device) - base[seg]
        order = torch.argsort(chunk, stable=True)  # chunk-major
        items = torch.stack([seg[order], chunk[order]]).to(torch.int32)
        return ChunkPlan(int(length), items.contiguous(),
                         base.to(torch.int32))


@dataclass(frozen=True)
class SegmentAxis:
    """An observation -> segment id axis, its CSR and its chunk plans.

    ids (O,) int32; perm (O,) int32 orders the observations by id
    (stable); offsets (n_seg + 1,) int32 delimit each segment in perm.
    The CUDA reductions also read rowsum_plan and pair_plan (chunks of
    ROWSUM_CHUNK and PAIR_CHUNK entries), the per-segment arrival
    counters (n_seg,) int32, zeroed here and left at zero by every call,
    and scratch for chunk partials, allocated at first use per width.
    `longest` is the largest segment's length."""
    ids: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    n_seg: int
    rowsum_plan: ChunkPlan | None = None
    pair_plan: ChunkPlan | None = None
    counters: torch.Tensor | None = None
    longest: int = 0
    scratch: dict = field(default_factory=dict, compare=False, repr=False)

    @staticmethod
    def build(ids: torch.Tensor, n_seg: int) -> "SegmentAxis":
        """Validate ids and build the CSR and the chunk plans (five host
        reads, once per axis)."""
        if ids.dim() != 1:
            raise ValueError(f"ids must be 1-D, got shape {tuple(ids.shape)}")
        ids32 = ids.to(torch.int32).contiguous()
        if ids32.numel():
            lo, hi = torch.aminmax(ids32)
            if int(lo) < 0 or int(hi) >= n_seg:
                raise ValueError(f"ids out of range [0, {n_seg}): "
                                 f"[{int(lo)}, {int(hi)}]")
        counts = torch.bincount(ids32.long(), minlength=n_seg)
        longest = int(counts.max()) if ids32.numel() else 0
        perm = torch.argsort(ids32, stable=True).to(torch.int32)
        offsets = torch.zeros(n_seg + 1, dtype=torch.int64, device=ids.device)
        offsets[1:] = torch.cumsum(counts, 0)
        offsets = offsets.to(torch.int32)
        return SegmentAxis(
            ids32, perm.contiguous(), offsets, int(n_seg),
            ChunkPlan.build(offsets, ROWSUM_CHUNK),
            ChunkPlan.build(offsets, PAIR_CHUNK),
            torch.zeros(n_seg, dtype=torch.int32, device=ids.device),
            int(longest))

    @property
    def num_obs(self) -> int:
        return self.ids.shape[0]

    def scratch_for(self, plan: ChunkPlan, width: int) -> torch.Tensor:
        """(n_items * width,) f32 for the chunk partials of `plan`, kept
        with the axis: calls on one axis are ordered on their stream, and
        every slot a call reads it has written first."""
        key = (plan.length, width)
        buf = self.scratch.get(key)
        if buf is None:
            buf = torch.empty(max(plan.n_items * width, 1),
                              dtype=torch.float32, device=self.ids.device)
            self.scratch[key] = buf
        return buf


# ----------------------------------------------------------------------------
# plain PyTorch versions
# ----------------------------------------------------------------------------


def projection_base_rows(x, y, omega, kind):
    """Kind base-map scalars (a, kq, da_dw), as in pallas_kernels:81:
      a(r):   (u, v) = a * (x, y)
      kq:     a'(r)/r, so d(u,v)/d(x,y) = a I + kq (x,y)(x,y)^T
      da_dw:  d a / d omega (FOV only; zero otherwise)."""
    is_fe = kind == 1.0
    is_fov = kind == 2.0
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rr2 = x * x + y * y
    rr = torch.sqrt(torch.clamp(rr2, min=1e-18))
    small_r = rr < 1e-6
    rr2s = torch.clamp(rr2, min=1e-18)
    # fisheye: a = atan(r)/r; a'(r) = (1/(1+r^2) - a)/r
    a_fe = torch.where(small_r, 1.0 - rr2 / 3.0, torch.atan(rr) / rr)
    kq_fe = torch.where(small_r, torch.full_like(x, -2.0 / 3.0),
                        (1.0 / (1.0 + rr2) - a_fe) / rr2s)
    # FOV: a = atan(2 r t)/(w r), t = tan(w/2); small omega -> identity
    w_ok = torch.abs(omega) > 1e-6
    w_safe = torch.where(w_ok, omega, torch.full_like(omega, 1e-6))
    tanh_ = torch.tan(0.5 * w_safe)
    q = 2.0 * rr * tanh_
    atq = torch.atan(q)
    iden_q = 1.0 / (1.0 + q * q)
    a_fov_raw = torch.where(small_r, 2.0 * tanh_ / w_safe,
                            atq / (w_safe * rr))
    kq_fov_raw = torch.where(
        small_r, -(16.0 * tanh_ ** 3) / (3.0 * w_safe),
        (2.0 * tanh_ * iden_q / w_safe - a_fov_raw) / rr2s)
    a_fov = torch.where(w_ok, a_fov_raw, one)
    kq_fov = torch.where(w_ok, kq_fov_raw, zero)
    sec2h = 1.0 + tanh_ * tanh_
    da_dw_raw = torch.where(
        small_r,
        sec2h / w_safe - 2.0 * tanh_ / (w_safe * w_safe),
        (rr * sec2h * iden_q - atq / w_safe) / (w_safe * rr))
    da_dw = torch.where(is_fov & w_ok, da_dw_raw, zero)
    a_sel = torch.where(is_fe, a_fe, torch.where(is_fov, a_fov, one))
    kq_sel = torch.where(is_fe, kq_fe, torch.where(is_fov, kq_fov, zero))
    return a_sel, kq_sel, da_dw


def projection_resid_jac_plain(M, S, bt, X, uv, intr, kind, ts=None):
    """Closed-form residual (2, O) and Jacobian (2*zdim, O), all kinds.

    A lane-major translation of _projection_kernel (pallas_kernels:135)
    with projection_base_rows folded in. J row `col + zdim * i` is
    d r_i / d z_col for z = [w(3) dt(3) dX(3) intr(16)[ ws(3) dts(3)]];
    zdim is 31 when the sensor translation rows `ts` are given."""
    zdim = 25 if ts is None else 31
    X0, X1, X2 = X[0], X[1], X[2]
    p0 = M[0] * X0 + M[1] * X1 + M[2] * X2 + bt[0]
    p1c = M[3] * X0 + M[4] * X1 + M[5] * X2 + bt[1]
    p2c = M[6] * X0 + M[7] * X1 + M[8] * X2 + bt[2]
    fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
    k1, k2, k3, k4 = intr[4], intr[5], intr[6], intr[7]
    d1, d2, d3 = intr[8], intr[9], intr[10]
    tp1, tp2 = intr[11], intr[12]
    sx1, sy1 = intr[13], intr[14]

    # |p2| < 1e-9 -> 1e-9 (also flips tiny negative depths, as the TPU did)
    z = torch.where(torch.abs(p2c) < 1e-9, torch.full_like(p2c, 1e-9), p2c)
    iz = 1.0 / z
    x = p0 * iz
    y = p1c * iz
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    a_sel, kq_sel, da_dw = projection_base_rows(p0 / z, p1c / z, intr[15],
                                                kind[0])

    u = x * a_sel
    v = y * a_sel
    G2xx = a_sel + kq_sel * x * x
    G2xy = kq_sel * x * y
    G2yy = a_sel + kq_sel * y * y

    r2 = u * u + v * v
    r4 = r2 * r2
    r6 = r4 * r2
    num = 1.0 + k1 * r2 + k2 * r4 + k3 * r6 + k4 * r4 * r4
    den = 1.0 + d1 * r2 + d2 * r4 + d3 * r6
    iden = 1.0 / den
    radial = num * iden
    xy2 = 2.0 * u * v
    du = u * radial + tp1 * xy2 + tp2 * (r2 + 2.0 * u * u) + sx1 * r2
    dv = v * radial + tp2 * xy2 + tp1 * (r2 + 2.0 * v * v) + sy1 * r2
    r = torch.stack([fx * du + cx - uv[0], fy * dv + cy - uv[1]])

    dnum = k1 + 2.0 * k2 * r2 + 3.0 * k3 * r4 + 4.0 * k4 * r6
    dden = d1 + 2.0 * d2 * r2 + 3.0 * d3 * r4
    drad = (dnum - radial * dden) * iden
    Dxx = radial + 2.0 * u * u * drad + 2.0 * tp1 * v + 6.0 * tp2 * u \
        + 2.0 * sx1 * u
    Dxy = 2.0 * u * v * drad + 2.0 * tp1 * u + 2.0 * tp2 * v + 2.0 * sx1 * v
    Dyx = 2.0 * u * v * drad + 2.0 * tp2 * v + 2.0 * tp1 * u + 2.0 * sy1 * u
    Dyy = radial + 2.0 * v * v * drad + 2.0 * tp2 * u + 6.0 * tp1 * v \
        + 2.0 * sy1 * v
    g00 = fx * (Dxx * G2xx + Dxy * G2xy)
    g01 = fx * (Dxx * G2xy + Dxy * G2yy)
    g10 = fy * (Dyx * G2xx + Dyy * G2xy)
    g11 = fy * (Dyx * G2xy + Dyy * G2yy)

    J0 = [zero] * zdim  # d r0 / d z
    J1 = [zero] * zdim  # d r1 / d z

    def col(c, e0, e1, e2):
        dx = iz * (e0 - x * e2)
        dy = iz * (e1 - y * e2)
        J0[c] = g00 * dx + g01 * dy
        J1[c] = g10 * dx + g11 * dy

    def mcol(v0, v1, v2):
        return (M[0] * v0 + M[1] * v1 + M[2] * v2,
                M[3] * v0 + M[4] * v1 + M[5] * v2,
                M[6] * v0 + M[7] * v1 + M[8] * v2)

    col(0, *mcol(zero, -X2, X1))
    col(1, *mcol(X2, zero, -X0))
    col(2, *mcol(-X1, X0, zero))
    col(3, S[0], S[3], S[6])
    col(4, S[1], S[4], S[7])
    col(5, S[2], S[5], S[8])
    col(6, M[0], M[3], M[6])
    col(7, M[1], M[4], M[7])
    col(8, M[2], M[5], M[8])
    J0[9], J1[10] = du, dv
    J0[11], J1[12] = one, one
    fxu = fx * u * iden
    fyv = fy * v * iden
    rp = one
    for s in range(4):  # k1..k4
        rp = rp * r2
        J0[13 + s], J1[13 + s] = fxu * rp, fyv * rp
    rp = one
    for s in range(3):  # d1..d3
        rp = rp * r2
        J0[17 + s], J1[17 + s] = -fxu * radial * rp, -fyv * radial * rp
    J0[20], J1[20] = fx * xy2, fy * (r2 + 2.0 * v * v)
    J0[21], J1[21] = fx * (r2 + 2.0 * u * u), fy * xy2
    J0[22], J1[23] = fx * r2, fy * r2
    du_dw = x * da_dw
    dv_dw = y * da_dw
    J0[24] = fx * (Dxx * du_dw + Dxy * dv_dw)
    J1[24] = fy * (Dyx * du_dw + Dyy * dv_dw)
    if ts is not None:
        # sensor-pose columns: dp/dws_k = (S e_k) x (p - t_s); dp/dts = I
        a0, a1, a2 = p0 - ts[0], p1c - ts[1], p2c - ts[2]
        for k in range(3):
            s0, s1, s2 = S[k], S[3 + k], S[6 + k]
            col(25 + k, s1 * a2 - s2 * a1, s2 * a0 - s0 * a2,
                s0 * a1 - s1 * a0)
        col(28, one, zero, zero)
        col(29, zero, one, zero)
        col(30, zero, zero, one)
    return r, torch.stack(J0 + J1)


def gather_plain(tab: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """tab (T, k), ids (O,) -> tab[ids].T (k, O)."""
    return tab[ids].T.contiguous()


def rowsum_plain(vals: torch.Tensor, ids: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    """vals (k, O), ids (O,) -> per-segment sums (n_seg, k)."""
    out = torch.zeros((n_seg, vals.shape[0]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, ids, vals.T)


def pair_rows(U: torch.Tensor, V: torch.Tensor, pairs) -> torch.Tensor:
    """(R, O) stack of rows[r] = sum_{(a, b) in pairs[r]} U[a] * V[b]."""
    return torch.stack([sum(U[a] * V[b] for a, b in terms)
                        for terms in pairs])


def pair_rowsum_plain(U, V, pairs, ids, n_seg: int) -> torch.Tensor:
    """out[s, r] = sum_{o in s} sum_{(a, b) in pairs[r]} U[a, o] V[b, o]."""
    return rowsum_plain(pair_rows(U, V, pairs), ids, n_seg)


def gather_dot_plain(tab: torch.Tensor, U: torch.Tensor,
                     ids: torch.Tensor) -> torch.Tensor:
    """tab (T, k), U (nr*k, O), ids (O,) -> (nr, O) with
    out[r, o] = sum_j U[r*k + j, o] * tab[ids[o], j]: J * gather(v)."""
    k = tab.shape[1]
    return (U.reshape(U.shape[0] // k, k, -1) * tab[ids].T[None]).sum(1)


def huber_irls_plain(r: torch.Tensor, delta: float, weight=None):
    """Residual rows (k, O) -> (IRLS weight, cost) of Ceres'
    HuberLoss(delta) at x = |r|^2, times `weight` (O,) when given:
    w = 1 and c = x inside delta, else w = delta / |r| and
    c = 2 delta |r| - delta^2, |r| = sqrt(max(x, 1e-30)). x adds the
    squares in row order, ((r0 r0 + r1 r1) + r2 r2), each operation
    rounded once, as huber.cu does. The division is tensor by tensor, one
    rounding (`delta / rn` would be rn.reciprocal() * delta in PyTorch,
    two)."""
    x = r[0] * r[0]
    for j in range(1, r.shape[0]):
        x = x + r[j] * r[j]
    d2 = delta * delta
    rn = torch.sqrt(torch.clamp(x, min=1e-30))
    inside = x <= d2
    w = torch.where(inside, torch.ones_like(x),
                    torch.full_like(rn, delta) / rn)
    c = torch.where(inside, x, (2.0 * delta) * rn - d2)
    if weight is not None:
        w, c = weight * w, weight * c
    return w, c


def sampson_score_plain(E9, x1T, x2T):
    """Squared Sampson error, E9 (9, M) row-major E per match, x1T, x2T
    (3, M) homogeneous points -> (M,); the body of
    glomap_tpu/math/two_view.py sampson_error_sq_rows."""
    z1 = x1T[2] + SAMPSON_EPS
    z2 = x2T[2] + SAMPSON_EPS
    a0, a1 = x1T[0] / z1, x1T[1] / z1
    b0, b1 = x2T[0] / z2, x2T[1] / z2
    one = torch.ones_like(a0)
    Ex0 = E9[0] * a0 + E9[1] * a1 + E9[2] * one
    Ex1 = E9[3] * a0 + E9[4] * a1 + E9[5] * one
    Ex2 = E9[6] * a0 + E9[7] * a1 + E9[8] * one
    Et0 = E9[0] * b0 + E9[3] * b1 + E9[6] * one
    Et1 = E9[1] * b0 + E9[4] * b1 + E9[7] * one
    C = Ex0 * b0 + Ex1 * b1 + Ex2 * one
    denom = Ex0 * Ex0 + Ex1 * Ex1 + Et0 * Et0 + Et1 * Et1
    return C * C / torch.clamp(denom, min=SAMPSON_EPS)


def ransac_chunk_plain(us, tab6, mask, counts, thr, best_E, best_cnt):
    """The rounds of `us` (R, P, 2, H) in turn: estimators/relpose.py's
    _ransac_round on the pair tables tab6 (P, 6, cap) and their lift,
    each folded into the running best (best_E (P, 3, 3), best_cnt (P,))."""
    # relpose imports this module, so it is imported here, at the call
    from glomap_tpu_torch.estimators import relpose
    lift = relpose._lift(tab6.unbind(1))
    for u in us:
        best_E, best_cnt = relpose._ransac_round(u, tab6, lift, mask, counts,
                                                 thr, best_E, best_cnt)
    return best_E, best_cnt


# ----------------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------------


def projection_resid_jac(M, S, bt, X, uv, intr, kind, ts=None):
    """(9,O) M, (9,O) S, (3,O) b, (3,O) X, (2,O) uv, (16,O) intrinsics,
    (1,O) kind [, (3,O) ts] -> (r (2,O), J (2*zdim,O))."""
    if M.device.type == "cpu":
        return projection_resid_jac_plain(M, S, bt, X, uv, intr, kind, ts)
    return _projection_resid_jac_cuda(M, S, bt, X, uv, intr, kind, ts)


def gather(tab: torch.Tensor, axis: SegmentAxis) -> torch.Tensor:
    """tab (n_seg, k) -> (k, O) rows tab[ids].T."""
    if tab.device.type == "cpu":
        return gather_plain(tab, axis.ids)
    return _gather_cuda(tab, axis)


def rowsum(vals: torch.Tensor, axis: SegmentAxis) -> torch.Tensor:
    """vals (k, O) -> (n_seg, k) per-segment sums."""
    if vals.device.type == "cpu":
        return rowsum_plain(vals, axis.ids, axis.n_seg)
    return _rowsum_cuda(vals, axis)


def pair_rowsum(U: torch.Tensor, V: torch.Tensor, pairs,
                axis: SegmentAxis) -> torch.Tensor:
    """(n_seg, R) sums of the pair-product rows; `pairs` a tuple (one
    entry per output column) of tuples of (a, b) row-index pairs."""
    if U.device.type == "cpu":
        return pair_rowsum_plain(U, V, pairs, axis.ids, axis.n_seg)
    return _pair_rowsum_cuda(U, V, pairs, axis)


def gather_dot(tab: torch.Tensor, U: torch.Tensor,
               axis: SegmentAxis) -> torch.Tensor:
    """tab (n_seg, k), U (nr*k, O) -> (nr, O),
    out[r, o] = sum_j U[r*k + j, o] * tab[ids[o], j]."""
    if tab.device.type == "cpu":
        return gather_dot_plain(tab, U, axis.ids)
    return _gather_dot_cuda(tab, U, axis)


def huber_irls(r: torch.Tensor, delta: float, weight=None):
    """Residual rows (k, O) [, weight (O,)] -> (weight * w, weight * c),
    the IRLS weights and costs of HuberLoss(delta) at |r|^2."""
    if r.device.type == "cpu":
        return huber_irls_plain(r, delta, weight)
    return _huber_irls_cuda(r, delta, weight)


def sampson_score(E9: torch.Tensor, x1T: torch.Tensor,
                  x2T: torch.Tensor) -> torch.Tensor:
    """E9 (9, M), x1T (3, M), x2T (3, M) -> squared Sampson error (M,)."""
    if E9.device.type == "cpu":
        return sampson_score_plain(E9, x1T, x2T)
    return _sampson_score_cuda(E9, x1T, x2T)


def ransac_chunk(us: torch.Tensor, tab6: torch.Tensor, mask: torch.Tensor,
                 counts: torch.Tensor, thr: torch.Tensor, best_E: torch.Tensor,
                 best_cnt: torch.Tensor):
    """R rounds of H 8-point hypotheses per pair, folded into the running
    best: draws us (R, P, 2, H) in [0, 2^30), tables tab6 (P, 6, cap),
    mask (P, cap), counts (P,) distinct slots, squared thresholds thr
    (P,), best_E (P, 3, 3), best_cnt (P,) -> the new (best_E, best_cnt)."""
    if tab6.device.type == "cpu":
        return ransac_chunk_plain(us, tab6, mask, counts, thr, best_E,
                                  best_cnt)
    return _ransac_chunk_cuda(us, tab6, mask, counts, thr, best_E, best_cnt)


# ----------------------------------------------------------------------------
# CUDA launches (ctypes)
# ----------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel name -> (C entry point, argtypes)
_SIGNATURES = {
    "projection": ("glomap_projection_resid_jac",
                   [_P] * 10 + [_I, _P]),
    "gather": ("glomap_gather", [_P, _P, _P] + [_I] * 7 + [_P]),
    "rowsum": ("glomap_rowsum", [_P] * 8 + [_I] * 4 + [_P]),
    "pair_rowsum": ("glomap_pair_rowsum", [_P] * 9 + [_I] * 15 + [_P]),
    "gather_dot": ("glomap_gather_dot", [_P] * 4 + [_I] * 4 + [_P]),
    "huber": ("glomap_huber_irls", [_P] * 4 + [_I] + [ctypes.c_float] * 3
              + [_I, _P]),
    "sampson": ("glomap_sampson", [_P] * 4 + [_I, _P]),
    "ransac": ("glomap_ransac_chunk", [_P] * 12 + [_I] * 4 + [_P]),
}
_entries: dict = {}
# pair_rowsum.cu: its ring of PAIR_STAGES staged sub-tiles of U and V rows
# (kStages there) fills PAIR_STAGE_BYTES of shared memory, which sets the
# sub-tile length from the rows alone; and the most output tiles a block
# holds (one per warp)
PAIR_STAGES = 3
PAIR_STAGE_BYTES = 48 << 10
PAIR_MAX_TILES = 8


def _entry(name: str):
    """The bound C function of kernel `name` (built at first use)."""
    fn = _entries.get(name)
    if fn is None:
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(_build.library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


def _stream(device: torch.device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_rows(name: str, t: torch.Tensor, rows: int, num_obs: int,
                device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, "
                         f"got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, "
                        f"got {t.dtype}")
    if tuple(t.shape) != (rows, num_obs):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"({rows}, {num_obs})")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_axis(axis: SegmentAxis, num_obs: int,
                device: torch.device) -> None:
    for name in ("ids", "perm", "offsets"):
        t = getattr(axis, name)
        if t.device != device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"axis.{name}: need contiguous int32 on {device}")
    if axis.num_obs != num_obs:
        raise ValueError(f"axis has {axis.num_obs} ids, rows have {num_obs}")
    for plan in (axis.rowsum_plan, axis.pair_plan):
        if plan is None or plan.items.device != device \
                or plan.chunk_base.device != device:
            raise ValueError(f"axis: needs its chunk plans on {device} "
                             "(SegmentAxis.build)")
    if axis.counters is None or axis.counters.device != device:
        raise ValueError(f"axis: needs its counters on {device}")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def _projection_resid_jac_cuda(M, S, bt, X, uv, intr, kind, ts=None):
    fn = _entry("projection")
    O = M.shape[1] if M.dim() == 2 else -1
    dev = M.device
    rows = [("M", M, 9), ("S", S, 9), ("b", bt, 3), ("X", X, 3),
            ("uv", uv, 2), ("intr", intr, 16), ("kind", kind, 1)]
    if ts is not None:
        rows.append(("ts", ts, 3))
    for name, t, k in rows:
        _check_rows(f"projection_resid_jac {name}", t, k, O, dev)
    zdim = 25 if ts is None else 31
    r = torch.empty((2, O), dtype=torch.float32, device=dev)
    J = torch.empty((2 * zdim, O), dtype=torch.float32, device=dev)
    rc = fn(M.data_ptr(), S.data_ptr(), bt.data_ptr(), X.data_ptr(),
            uv.data_ptr(), intr.data_ptr(), kind.data_ptr(),
            ts.data_ptr() if ts is not None else None,
            r.data_ptr(), J.data_ptr(), O, _stream(dev))
    _raise_on(rc, "projection_resid_jac")
    LAUNCHES["projection_resid_jac"] += 1
    return r, J


def _gather_cuda(tab: torch.Tensor, axis: SegmentAxis) -> torch.Tensor:
    fn = _entry("gather")
    if tab.dim() != 2 or tab.shape[0] != axis.n_seg:
        raise ValueError(f"gather: table shape {tuple(tab.shape)}, expected "
                         f"({axis.n_seg}, k)")
    dev = tab.device
    _check_rows("gather tab", tab, axis.n_seg, tab.shape[1], dev)
    _check_axis(axis, axis.num_obs, dev)
    k, O = tab.shape[1], axis.num_obs
    out = torch.empty((k, O), dtype=torch.float32, device=dev)
    mode, width, pitch, smem = gather_plan(axis.n_seg, k, O)
    rc = fn(tab.data_ptr(), axis.ids.data_ptr(), out.data_ptr(),
            axis.n_seg, k, O, mode, width, pitch, smem, _stream(dev))
    _raise_on(rc, "gather")
    LAUNCHES["gather"] += 1
    return out


def _rowsum_cuda(vals: torch.Tensor, axis: SegmentAxis) -> torch.Tensor:
    fn = _entry("rowsum")
    dev = vals.device
    k = vals.shape[0] if vals.dim() == 2 else -1
    _check_rows("rowsum vals", vals, k, axis.num_obs, dev)
    _check_axis(axis, axis.num_obs, dev)
    plan = axis.rowsum_plan
    out = torch.empty((axis.n_seg, k), dtype=torch.float32, device=dev)
    scratch = axis.scratch_for(plan, k)
    rc = fn(vals.data_ptr(), axis.perm.data_ptr(), axis.offsets.data_ptr(),
            plan.items.data_ptr(), plan.chunk_base.data_ptr(),
            axis.counters.data_ptr(), scratch.data_ptr(), out.data_ptr(), k,
            axis.num_obs, plan.n_items, plan.length, _stream(dev))
    _raise_on(rc, "rowsum")
    LAUNCHES["rowsum"] += 1
    return out


_forms: dict = {}


def product_form(pairs, ku: int, kv: int) -> tuple:
    """(n, m, T, a0, sa_i, sa_t, b0, sb_j, sb_t) such that
      pairs[i*m + j] == ((a0 + i*sa_i + t*sa_t, b0 + j*sb_j + t*sb_t)
                         for t < T)
    for every i < n, j < m: the (n x m) block of T rank-1 terms that
    pair_rowsum.cu takes, cached per (pairs, ku, kv). Every table of the
    BA solver has this form: J^T y (m = 1), the Grams and the Schur
    corrections. Raises ValueError for a table of another shape, for a row
    index outside U (ku rows) or V (kv rows), and for a block of more
    output tiles than the kernel's warps."""
    key = (pairs, ku, kv)
    form = _forms.get(key)
    if form is not None:
        return form
    table = tuple(tuple(tuple(p) for p in terms) for terms in pairs)
    R = len(table)
    if R == 0 or not table[0]:
        raise ValueError("pair_rowsum: empty pairs")
    T = len(table[0])
    (a0, b0), a_rows = table[0][0], [[p[0] for p in t] for t in table]
    m = 1
    while m < R and a_rows[m] == a_rows[0]:
        m += 1
    n = R // m
    sa_t, sb_t = (table[0][1][0] - a0, table[0][1][1] - b0) if T > 1 \
        else (0, 0)
    sa_i = table[m][0][0] - a0 if n > 1 else 0
    sb_j = table[1][0][1] - b0 if m > 1 else 0
    expect = tuple(tuple((a0 + i * sa_i + t * sa_t, b0 + j * sb_j + t * sb_t)
                         for t in range(T))
                   for i in range(n) for j in range(m))
    if expect != table:
        raise ValueError("pair_rowsum: the CUDA kernel takes pairs of the "
                         "form out[i*m + j] = sum_t U[a0 + i*sa_i + t*sa_t] "
                         "* V[b0 + j*sb_j + t*sb_t]")
    for terms in table:
        for a, b in terms:
            if not (0 <= a < ku and 0 <= b < kv):
                raise ValueError(f"pair ({a}, {b}) out of range for U rows "
                                 f"{ku}, V rows {kv}")
    ti, tj, groups = pair_tiles(n, m)
    if not groups:
        raise ValueError(f"pair_rowsum: a {n} x {m} block is more than "
                         f"{PAIR_MAX_TILES} tiles of {ti} x {tj}")
    form = (n, m, T, a0, sa_i, sa_t, b0, sb_j, sb_t)
    _forms[key] = form
    return form


def pair_tiles(n: int, m: int) -> tuple:
    """(TI, TJ, WG): pair_rowsum.cu's warp tile of an n x m block (16 x 1
    for J^T y, else 4 x 8) and the warps that share each tile, splitting
    the chunk by rows of 32 observations; WG is 0 when the block needs
    more tiles than the kernel has warps."""
    ti, tj = (16, 1) if m == 1 else (4, 8)
    return ti, tj, PAIR_MAX_TILES // (-(-n // ti) * -(-m // tj))


def pair_stage_len(rows: int, longest: int) -> int:
    """Observations per staged sub-tile of pair_rowsum.cu: the largest
    power of two whose PAIR_STAGES buffers of `rows` rows fit
    PAIR_STAGE_BYTES, within [32, PAIR_CHUNK] and no longer than the
    longest segment needs. It sets only how a chunk is staged, never the
    order of a sum."""
    need = max(32, min(longest, PAIR_CHUNK))
    s = 32
    while s < need and PAIR_STAGES * rows * (2 * s) * 4 <= PAIR_STAGE_BYTES:
        s *= 2
    return s


def gather_plan(n_rows: int, k: int, num_obs: int) -> tuple:
    """(mode, width, pitch, smem_bytes) of gather.cu for a table of
    n_rows x k gathered onto num_obs observations. GATHER_WHOLE stages
    the table in each block's shared memory, rows at the odd pitch k | 1
    (neighbouring rows on other banks), where 1 < n_rows <=
    GATHER_WHOLE_ROWS, k >= GATHER_WHOLE_K and it fits GATHER_SMEM_BYTES:
    a point-major frame axis, whose warps read many rows of a wide table
    at once; otherwise GATHER_DIRECT reads it in place through L1. width
    is 4 observations a thread (16-byte stores) for tables of at most 2
    columns on GATHER_WIDE_OBS or more observations, else 1."""
    pitch = k | 1
    whole = (1 < n_rows <= GATHER_WHOLE_ROWS and k >= GATHER_WHOLE_K
             and 4 * n_rows * pitch <= GATHER_SMEM_BYTES)
    width = 4 if k <= 2 and num_obs >= GATHER_WIDE_OBS else 1
    return ((GATHER_WHOLE, width, pitch, 4 * n_rows * pitch) if whole
            else (GATHER_DIRECT, width, pitch, 0))


def _pair_rowsum_cuda(U, V, pairs, axis: SegmentAxis) -> torch.Tensor:
    fn = _entry("pair_rowsum")
    dev = U.device
    O = axis.num_obs
    ku = U.shape[0] if U.dim() == 2 else -1
    kv = V.shape[0] if V.dim() == 2 else -1
    _check_rows("pair_rowsum U", U, ku, O, dev)
    _check_rows("pair_rowsum V", V, kv, O, dev)
    _check_axis(axis, O, dev)
    n, m, T, a0, sa_i, sa_t, b0, sb_j, sb_t = product_form(pairs, ku, kv)
    same = U.data_ptr() == V.data_ptr() and ku == kv  # stage one read
    rows = ku if same else ku + kv
    plan = axis.pair_plan
    out = torch.empty((axis.n_seg, n * m), dtype=torch.float32, device=dev)
    scratch = axis.scratch_for(plan, n * m)
    lg_s = pair_stage_len(rows, axis.longest).bit_length() - 1
    rc = fn(U.data_ptr(), V.data_ptr(), axis.perm.data_ptr(),
            axis.offsets.data_ptr(), plan.items.data_ptr(),
            plan.chunk_base.data_ptr(), axis.counters.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), n, m, T, a0, sa_i, sa_t,
            b0 + (0 if same else ku), sb_j, sb_t, ku, rows, O, plan.n_items,
            plan.length, lg_s, _stream(dev))
    _raise_on(rc, "pair_rowsum")
    LAUNCHES["pair_rowsum"] += 1
    return out


def _gather_dot_cuda(tab: torch.Tensor, U: torch.Tensor,
                     axis: SegmentAxis) -> torch.Tensor:
    fn = _entry("gather_dot")
    if tab.dim() != 2 or tab.shape[0] != axis.n_seg or tab.shape[1] == 0:
        raise ValueError(f"gather_dot: table shape {tuple(tab.shape)}, "
                         f"expected ({axis.n_seg}, k > 0)")
    dev = tab.device
    k, O = tab.shape[1], axis.num_obs
    _check_rows("gather_dot tab", tab, axis.n_seg, k, dev)
    rows = U.shape[0] if U.dim() == 2 else -1
    if rows % k:
        raise ValueError(f"gather_dot: U has {rows} rows, not a multiple "
                         f"of k = {k}")
    _check_rows("gather_dot U", U, rows, O, dev)
    _check_axis(axis, O, dev)
    nr = rows // k
    out = torch.empty((nr, O), dtype=torch.float32, device=dev)
    rc = fn(tab.data_ptr(), axis.ids.data_ptr(), U.data_ptr(),
            out.data_ptr(), axis.n_seg, k, nr, O, _stream(dev))
    _raise_on(rc, "gather_dot")
    LAUNCHES["gather_dot"] += 1
    return out


def _huber_irls_cuda(r: torch.Tensor, delta: float, weight=None):
    fn = _entry("huber")
    dev = r.device
    k = r.shape[0] if r.dim() == 2 else -1
    if k not in (2, 3):
        raise ValueError(f"huber_irls: the CUDA kernel takes 2 or 3 residual "
                         f"rows, got shape {tuple(r.shape)}")
    O = r.shape[1]
    _check_rows("huber_irls r", r, k, O, dev)
    if weight is not None:
        _check_rows("huber_irls weight", weight[None], 1, O, dev)
    w = torch.empty((O,), dtype=torch.float32, device=dev)
    c = torch.empty((O,), dtype=torch.float32, device=dev)
    # the plain version's f32 constants: PyTorch rounds each Python
    # scalar to the tensor's dtype, as ctypes.c_float does here
    rc = fn(r.data_ptr(), None if weight is None else weight.data_ptr(),
            w.data_ptr(), c.data_ptr(), k, float(delta),
            float(delta) * float(delta), 2.0 * float(delta), O, _stream(dev))
    _raise_on(rc, "huber_irls")
    LAUNCHES["huber"] += 1
    return w, c


def _sampson_score_cuda(E9, x1T, x2T) -> torch.Tensor:
    fn = _entry("sampson")
    M = E9.shape[1] if E9.dim() == 2 else -1
    dev = E9.device
    for name, t, k in (("E", E9, 9), ("x1", x1T, 3), ("x2", x2T, 3)):
        _check_rows(f"sampson_score {name}", t, k, M, dev)
    out = torch.empty((M,), dtype=torch.float32, device=dev)
    rc = fn(E9.data_ptr(), x1T.data_ptr(), x2T.data_ptr(), out.data_ptr(), M,
            _stream(dev))
    _raise_on(rc, "sampson_score")
    LAUNCHES["sampson"] += 1
    return out


def _check_tensor(name: str, t: torch.Tensor, shape: tuple,
                  dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {shape}, got "
                         f"{tuple(t.shape)}")


def _ransac_chunk_cuda(us, tab6, mask, counts, thr, best_E, best_cnt):
    fn = _entry("ransac")
    dev = tab6.device
    if dev.type != "cuda":
        raise ValueError(f"ransac_chunk: the CUDA kernel needs a CUDA "
                         f"tensor, got {dev}")
    P, _, cap = tab6.shape
    R, H = us.shape[0], us.shape[-1]
    for name, t, shape, dtype in (
            ("us", us, (R, P, 2, H), torch.int64),
            ("tab6", tab6, (P, 6, cap), torch.float32),
            ("mask", mask, (P, cap), torch.bool),
            ("counts", counts, (P,), torch.int64),
            ("thr", thr, (P,), torch.float32),
            ("best_E", best_E, (P, 3, 3), torch.float32),
            ("best_cnt", best_cnt, (P,), torch.int64)):
        _check_tensor(f"ransac_chunk {name}", t, shape, dtype, dev)
    out_E = torch.empty((P, 3, 3), dtype=torch.float32, device=dev)
    out_cnt = torch.empty((P,), dtype=torch.int64, device=dev)
    scratch_cnt = torch.empty((P, R), dtype=torch.int32, device=dev)
    scratch_E = torch.empty((P, R, 9), dtype=torch.float32, device=dev)
    counters = torch.zeros((P,), dtype=torch.int32, device=dev)
    rc = fn(us.data_ptr(), tab6.data_ptr(), mask.data_ptr(),
            counts.data_ptr(), thr.data_ptr(), best_E.data_ptr(),
            best_cnt.data_ptr(), scratch_cnt.data_ptr(), scratch_E.data_ptr(),
            counters.data_ptr(), out_E.data_ptr(), out_cnt.data_ptr(), P, R,
            H, cap, _stream(dev))
    _raise_on(rc, "ransac_chunk")
    LAUNCHES["ransac"] += 1
    return out_E, out_cnt
