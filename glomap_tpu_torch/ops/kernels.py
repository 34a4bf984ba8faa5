"""The port's CUDA kernels: wrappers, plain versions, counters.

Counterpart of glomap_tpu/ops/pallas_kernels.py. Each kernel comes in
three parts:

  * a wrapper (`projection_resid_jac`, `gather`, `rowsum`,
    `pair_rowsum`, `gather_dot`, `huber_weight_cost`, `sampson_score`)
    that takes the plain version for a
    CPU tensor and otherwise launches the CUDA kernel (`_*_cuda`) or
    raises -- there is no fallback;
  * the plain PyTorch version (`*_plain`), the reference the tests and
    chip_smoke.py hold the kernel against;
  * a launch counter in LAUNCHES, incremented only where the kernel is
    launched.

Layouts are the JAX package's: per-observation data as (k, O) row stacks
with the observation axis contiguous, so a thread per observation reads
and writes coalesced rows. Segment reductions read the CSR of their id
axis (`SegmentAxis`: ids, a stable argsort `perm`, `offsets`), built once
per solve; each segment is summed by one block in a fixed order, so the
results are deterministic.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from glomap_tpu_torch.ops import _build

LAUNCHES = {"projection_resid_jac": 0, "gather": 0, "rowsum": 0,
            "pair_rowsum": 0, "gather_dot": 0, "huber": 0, "sampson": 0}
# the z-normalisation offset and denominator clamp of the Sampson error
SAMPSON_EPS = 1e-12


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ----------------------------------------------------------------------------
# id axes
# ----------------------------------------------------------------------------


@dataclass(frozen=True)
class SegmentAxis:
    """An observation -> segment id axis and its CSR.

    ids (O,) int32; perm (O,) int32 orders the observations by id
    (stable); offsets (n_seg + 1,) int32 delimit each segment in perm."""
    ids: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    n_seg: int

    @staticmethod
    def build(ids: torch.Tensor, n_seg: int) -> "SegmentAxis":
        """Validate ids once (one host read) and build the CSR."""
        if ids.dim() != 1:
            raise ValueError(f"ids must be 1-D, got shape {tuple(ids.shape)}")
        ids32 = ids.to(torch.int32).contiguous()
        if ids32.numel():
            lo, hi = torch.aminmax(ids32)
            if int(lo) < 0 or int(hi) >= n_seg:
                raise ValueError(f"ids out of range [0, {n_seg}): "
                                 f"[{int(lo)}, {int(hi)}]")
        perm = torch.argsort(ids32, stable=True).to(torch.int32)
        counts = torch.bincount(ids32.long(), minlength=n_seg)
        offsets = torch.zeros(n_seg + 1, dtype=torch.int64, device=ids.device)
        offsets[1:] = torch.cumsum(counts, 0)
        return SegmentAxis(ids32, perm.contiguous(),
                           offsets.to(torch.int32), int(n_seg))

    @property
    def num_obs(self) -> int:
        return self.ids.shape[0]


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


def huber_weight_cost_plain(r2: torch.Tensor, delta: float):
    """Squared norms (O,) -> (IRLS weight, cost) of Ceres'
    HuberLoss(delta): w = 1 and c = r2 inside delta, else w = delta / |r|
    and c = 2 delta |r| - delta^2; |r| = sqrt(max(r2, 1e-30)). The
    division is tensor by tensor, one rounding (`delta / rn` would be
    rn.reciprocal() * delta in PyTorch, two)."""
    d2 = delta * delta
    rn = torch.sqrt(torch.clamp(r2, min=1e-30))
    inside = r2 <= d2
    w = torch.where(inside, torch.ones_like(r2),
                    torch.full_like(rn, delta) / rn)
    c = torch.where(inside, r2, (2.0 * delta) * rn - d2)
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


def huber_weight_cost(r2: torch.Tensor, delta: float):
    """(O,) squared norms -> (weights (O,), costs (O,)) of HuberLoss."""
    if r2.device.type == "cpu":
        return huber_weight_cost_plain(r2, delta)
    return _huber_weight_cost_cuda(r2, delta)


def sampson_score(E9: torch.Tensor, x1T: torch.Tensor,
                  x2T: torch.Tensor) -> torch.Tensor:
    """E9 (9, M), x1T (3, M), x2T (3, M) -> squared Sampson error (M,)."""
    if E9.device.type == "cpu":
        return sampson_score_plain(E9, x1T, x2T)
    return _sampson_score_cuda(E9, x1T, x2T)


# ----------------------------------------------------------------------------
# CUDA launches (ctypes)
# ----------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel name -> (C entry point, argtypes)
_SIGNATURES = {
    "projection": ("glomap_projection_resid_jac",
                   [_P] * 10 + [_I, _P]),
    "gather": ("glomap_gather", [_P, _P, _P, _I, _I, _I, _P]),
    "rowsum": ("glomap_rowsum", [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "pair_rowsum": ("glomap_pair_rowsum", [_P] * 6 + [_I] * 5 + [_P]),
    "gather_dot": ("glomap_gather_dot", [_P] * 4 + [_I] * 4 + [_P]),
    "huber": ("glomap_huber", [_P] * 3 + [ctypes.c_float] * 3 + [_I, _P]),
    "sampson": ("glomap_sampson", [_P] * 4 + [_I, _P]),
}
_entries: dict = {}
# segment reductions: threads per block and most output columns per block
_BLOCK = 256
_MAX_COLS = 8
# blocks wanted in flight (4 per SM of an H100 SXM)
_TARGET_BLOCKS = 528


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


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def _cols_per_block(n_seg: int, R: int) -> int:
    """Output columns per block: enough blocks for the card, at most 8."""
    return max(1, min(_MAX_COLS, R, (n_seg * R) // _TARGET_BLOCKS))


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
    rc = fn(tab.data_ptr(), axis.ids.data_ptr(), out.data_ptr(),
            axis.n_seg, k, O, _stream(dev))
    _raise_on(rc, "gather")
    LAUNCHES["gather"] += 1
    return out


def _rowsum_cuda(vals: torch.Tensor, axis: SegmentAxis) -> torch.Tensor:
    fn = _entry("rowsum")
    dev = vals.device
    k = vals.shape[0] if vals.dim() == 2 else -1
    _check_rows("rowsum vals", vals, k, axis.num_obs, dev)
    _check_axis(axis, axis.num_obs, dev)
    out = torch.empty((axis.n_seg, k), dtype=torch.float32, device=dev)
    rc = fn(vals.data_ptr(), axis.perm.data_ptr(), axis.offsets.data_ptr(),
            out.data_ptr(), k, axis.num_obs, axis.n_seg,
            _cols_per_block(axis.n_seg, k), _stream(dev))
    _raise_on(rc, "rowsum")
    LAUNCHES["rowsum"] += 1
    return out


_term_tables: dict = {}


def term_table(pairs, ku: int, kv: int, device) -> torch.Tensor:
    """int32 [offsets (R+1) | a (T) | b (T)] encoding of `pairs`, cached
    per (pairs, device); row indices are checked against U and V."""
    key = (pairs, str(device))
    tab = _term_tables.get(key)
    if tab is None:
        offsets, a_idx, b_idx = [0], [], []
        for terms in pairs:
            for a, b in terms:
                if not (0 <= a < ku and 0 <= b < kv):
                    raise ValueError(f"pair ({a}, {b}) out of range for "
                                     f"U rows {ku}, V rows {kv}")
                a_idx.append(a)
                b_idx.append(b)
            offsets.append(len(a_idx))
        tab = torch.tensor(offsets + a_idx + b_idx, dtype=torch.int32,
                           device=device)
        _term_tables[key] = tab
    return tab


def _pair_rowsum_cuda(U, V, pairs, axis: SegmentAxis) -> torch.Tensor:
    fn = _entry("pair_rowsum")
    dev = U.device
    O = axis.num_obs
    ku = U.shape[0] if U.dim() == 2 else -1
    kv = V.shape[0] if V.dim() == 2 else -1
    _check_rows("pair_rowsum U", U, ku, O, dev)
    _check_rows("pair_rowsum V", V, kv, O, dev)
    _check_axis(axis, O, dev)
    R = len(pairs)
    terms = term_table(pairs, ku, kv, dev)
    out = torch.empty((axis.n_seg, R), dtype=torch.float32, device=dev)
    rc = fn(U.data_ptr(), V.data_ptr(), terms.data_ptr(),
            axis.perm.data_ptr(), axis.offsets.data_ptr(), out.data_ptr(),
            R, (terms.shape[0] - (R + 1)) // 2, O, axis.n_seg,
            _cols_per_block(axis.n_seg, R), _stream(dev))
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


def _huber_weight_cost_cuda(r2: torch.Tensor, delta: float):
    fn = _entry("huber")
    dev = r2.device
    O = r2.shape[0] if r2.dim() == 1 else -1
    _check_rows("huber_weight_cost r2", r2[None], 1, O, dev)
    w = torch.empty((O,), dtype=torch.float32, device=dev)
    c = torch.empty((O,), dtype=torch.float32, device=dev)
    # the plain version's f32 constants: PyTorch rounds each Python
    # scalar to the tensor's dtype, as ctypes.c_float does here
    rc = fn(r2.data_ptr(), w.data_ptr(), c.data_ptr(), float(delta),
            float(delta) * float(delta), 2.0 * float(delta), O, _stream(dev))
    _raise_on(rc, "huber_weight_cost")
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
