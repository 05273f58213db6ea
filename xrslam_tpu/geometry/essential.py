"""5-point essential matrix (Nistér) — batched formulation.

reference: xrslam/src/xrslam/geometry/essential.cpp — the reference
builds the 10×20 Gröbner polynomial system over GRevLex monomials
(essential.cpp:9-160), Gauss-Jordan eliminates, and solves a 10×10
action matrix with an *unsymmetric* eigendecomposition
(essential.cpp:203-219). Unsymmetric `eig` has no batched accelerator
lowering in JAX, so we use an equivalent and fully-batched path:

  1. nullspace basis E(x,y,z) = x·E1 + y·E2 + z·E3 + E4 from the 5
     correspondences (eigh of AᵀA),
  2. the same 10 cubic constraints (det E = 0, 2EEᵀE − tr(EEᵀ)E = 0),
     assembled by generic trivariate polynomial arithmetic,
  3. viewing the system as C(z)·m(x,y) = 0 with m the ten (x,y)
     monomials, solutions require det C(z) = 0 — a degree-10
     polynomial in z. We recover its coefficients by *evaluating the
     determinant at Chebyshev samples and least-squares fitting* (all
     batched dets of 10×10), on two charts (z and w = 1/z) to cover the
     whole real line,
  4. real roots by sign-change bisection (fixed iterations, branchless),
     polished by Newton steps,
  5. per root, the (x,y) solution is the null vector of C(z*).

Convention: returned E satisfies x2ᵀ E x1 = 0 for homogeneous
normalized image points (E ≅ [T]× R with x2 ≅ R x1 + T).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------------------
# trivariate polynomial machinery (static index maps, built once)
# ---------------------------------------------------------------------------

# canonical monomial lists as exponent tuples (i,j,k) for x^i y^j z^k
_DEG1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]  # x, y, z, 1
_DEG2 = [
    (2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1), (0, 0, 2),
    (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
_DEG3 = [
    (3, 0, 0), (2, 1, 0), (1, 2, 0), (0, 3, 0),
    (2, 0, 1), (1, 1, 1), (0, 2, 1),
    (1, 0, 2), (0, 1, 2), (0, 0, 3),
    (2, 0, 0), (1, 1, 0), (0, 2, 0), (1, 0, 1), (0, 1, 1), (0, 0, 2),
    (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]


def _mul_table(alist, blist, outlist):
    idx = {m: i for i, m in enumerate(outlist)}
    table = []
    for i, a in enumerate(alist):
        for j, b in enumerate(blist):
            m = (a[0] + b[0], a[1] + b[1], a[2] + b[2])
            table.append((i, j, idx[m]))
    return table


_T11 = _mul_table(_DEG1, _DEG1, _DEG2)
_T21 = _mul_table(_DEG2, _DEG1, _DEG3)


def _pmul(a, b, table, out_n):
    """Multiply batched polynomials: a (...,Na), b (...,Nb) -> (...,out_n)."""
    out = [jnp.zeros(a.shape[:-1], dtype=a.dtype) for _ in range(out_n)]
    for i, j, k in table:
        out[k] = out[k] + a[..., i] * b[..., j]
    return jnp.stack(out, axis=-1)


def _p11(a, b):
    return _pmul(a, b, _T11, len(_DEG2))


def _p21(a, b):
    return _pmul(a, b, _T21, len(_DEG3))


# map DEG3 coefficients -> C(z) matrix layout: (xy-monomial column, z power)
# xy-monomial order: [x³, x²y, xy², y³, x², xy, y², x, y, 1]
_XY_MONOS = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]
_COL_OF = {m: c for c, m in enumerate(_XY_MONOS)}
_C_MAP = [(_COL_OF[(i, j)], k) for (i, j, k) in _DEG3]  # per DEG3 coeff


def _constraint_polys(basis):
    """The 10 cubic constraints as (...,10,20) coefficient arrays.

    basis: (...,9,4) nullspace (columns E1,E2,E3,E4, row-major 3×3).
    """
    # E entries as degree-1 polynomials: coeffs (...,3,3,4)
    Ep = basis.reshape(basis.shape[:-2] + (3, 3, 4))

    def p1(i, j):
        return Ep[..., i, j, :]

    # EEt[i][j] = sum_k E[i,k] * E[j,k]  (degree 2)
    EEt = [[sum_poly([_p11(p1(i, k), p1(j, k)) for k in range(3)]) for j in range(3)] for i in range(3)]
    trace = add_polys(add_polys(EEt[0][0], EEt[1][1]), EEt[2][2])

    rows = []
    # (EEt @ E)[i][j] - 0.5*trace*E[i][j]   (degree 3)
    for i in range(3):
        for j in range(3):
            t = sum_poly([_p21(EEt[i][k], p1(k, j)) for k in range(3)])
            t = t - 0.5 * _p21(trace, p1(i, j))
            rows.append(t)
    # det(E) (degree 3): cofactor expansion
    def d2(a, b, c, d):
        return _p11(p1(*a), p1(*b)) - _p11(p1(*c), p1(*d))

    det = (
        _p21(d2((1, 1), (2, 2), (1, 2), (2, 1)), p1(0, 0))
        - _p21(d2((1, 0), (2, 2), (1, 2), (2, 0)), p1(0, 1))
        + _p21(d2((1, 0), (2, 1), (1, 1), (2, 0)), p1(0, 2))
    )
    rows.append(det)
    return jnp.stack(rows, axis=-2)  # (...,10,20)


def sum_poly(ps):
    out = ps[0]
    for p in ps[1:]:
        out = out + p
    return out


def add_polys(a, b):
    return a + b


_C_TABLE = np.zeros((len(_C_MAP), 10, 4))
for _m, (_col, _zpow) in enumerate(_C_MAP):
    _C_TABLE[_m, _col, _zpow] = 1.0


def _c_of_z(polys, z):
    """Evaluate C(z): polys (...,10,20), z (...,) -> (...,10,10).

    One einsum against the static (monomial -> column, z-power) table —
    a scatter-add loop here poisons the layout of everything downstream
    (see CLAUDE.md performance rules)."""
    zp = jnp.stack([jnp.ones_like(z), z, z * z, z * z * z], axis=-1)  # (...,4)
    T = jnp.asarray(_C_TABLE, dtype=polys.dtype)
    return jnp.einsum("...rm,mcp,...p->...rc", polys, T, zp)


def nullspace_basis(x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """(...,5,3) bearings/homogeneous points -> (...,9,4) nullspace of the
    epipolar constraints x2ᵀ E x1 = 0 (reference essential.cpp:108-120,
    transposed to our convention)."""
    # row for E row-major: coeff of E_ij is x2_i * x1_j
    A = jnp.einsum("...ni,...nj->...nij", x2, x1).reshape(x1.shape[:-2] + (5, 9))
    ata = jnp.einsum("...ni,...nj->...ij", A, A)
    _, v = jnp.linalg.eigh(ata)
    return v[..., :, 0:4]  # 4 smallest


def _poly_roots_real(coeffs, grid: int = 64, iters: int = 40):
    """Real roots of batched degree-10 polynomials on [-1, 1] via
    sign-change bisection. coeffs (...,11) low-to-high. Returns
    (roots (...,R), valid (...,R)) with R = grid slots of sign changes
    (at most 10 real)."""

    def evalp(c, z):
        # Horner, z (...,G)
        out = jnp.zeros_like(z)
        for k in range(c.shape[-1] - 1, -1, -1):
            out = out * z + c[..., k][..., None]
        return out

    z = jnp.linspace(-1.0, 1.0, grid, dtype=coeffs.dtype)
    zb = jnp.broadcast_to(z, coeffs.shape[:-1] + (grid,))
    vals = evalp(coeffs, zb)
    sign_change = (vals[..., :-1] * vals[..., 1:]) < 0  # (...,G-1)
    lo = zb[..., :-1]
    hi = zb[..., 1:]
    vlo = vals[..., :-1]

    def body(_, carry):
        # carry vlo across iterations: one poly eval per step, not two
        lo, hi, vlo = carry
        mid = 0.5 * (lo + hi)
        vmid = evalp(coeffs, mid)
        same = (vlo * vmid) > 0
        lo = jnp.where(same, mid, lo)
        hi = jnp.where(same, hi, mid)
        vlo = jnp.where(same, vmid, vlo)
        return lo, hi, vlo

    lo, hi, _ = jax.lax.fori_loop(0, iters, body, (lo, hi, vlo))
    roots = 0.5 * (lo + hi)
    return roots, sign_change


@partial(jax.jit, static_argnames=("n_samples",))
def solve_essential_5pt(x1: jnp.ndarray, x2: jnp.ndarray, n_samples: int = 16):
    """Batched Nistér 5-point solver.

    Args:
      x1, x2: (...,5,3) homogeneous normalized points (z=1 or bearings).

    Returns (E (...,R,3,3), valid (...,R)) with R = 12 compacted root
    slots, masked to the actual real solutions (≤10).
    """
    dtype = x1.dtype
    basis = nullspace_basis(x1, x2)          # (...,9,4)
    polys = _constraint_polys(basis)          # (...,10,20)

    # --- det C(z) as a degree-10 polynomial, fit from Chebyshev samples
    ks = np.arange(n_samples)
    zs_np = np.cos((2 * ks + 1) * np.pi / (2 * n_samples))  # Chebyshev nodes in (-1,1)
    zs = jnp.asarray(zs_np, dtype=dtype)
    pinv = jnp.asarray(np.linalg.pinv(np.vander(zs_np, 11, increasing=True)), dtype=dtype)

    def det_at(z):
        C = _c_of_z(polys, jnp.broadcast_to(z, polys.shape[:-2]))
        return jnp.linalg.det(C)

    dets = jnp.stack([det_at(zs[s]) for s in range(n_samples)], axis=-1)  # (...,S)
    # normalize per-problem scale to condition the fit
    dets = dets / jnp.maximum(jnp.max(jnp.abs(dets), axis=-1, keepdims=True), 1e-300)
    # chart A: p(z) on [-1,1]
    coeffs_a = jnp.einsum("cs,...s->...c", pinv, dets)  # (...,11)
    # chart B: q(w) = w^10 p(1/w) on [-1,1]  (roots w → z = 1/w, |z|≥1);
    # q's coefficients are p's reversed, so fit p once and reverse
    coeffs_b = coeffs_a[..., ::-1]

    # both charts in one batched bisection (roots beyond f32 resolution
    # gain nothing from >32 halvings of [-1,1])
    roots_ab, val_ab = _poly_roots_real(
        jnp.stack([coeffs_a, coeffs_b], axis=0), iters=32)
    roots_a, roots_b = roots_ab[0], roots_ab[1]
    val_a, val_b = val_ab[0], val_ab[1]
    # w≈0 → |z|→∞: drop tiny w
    val_b = val_b & (jnp.abs(roots_b) > 1e-8)
    z_all = jnp.concatenate([roots_a, 1.0 / jnp.where(jnp.abs(roots_b) > 1e-8, roots_b, 1.0)], axis=-1)
    valid = jnp.concatenate([val_a, val_b], axis=-1)  # (...,2(G-1))

    # compact: a degree-10 polynomial has at most 10 real roots (plus
    # possible chart-boundary duplicates at |z|=1), so only ≤12 of the
    # 2(G-1) bisection slots can be valid — gather them to the front and
    # run the expensive null-vector solve on 12 slots instead of 126.
    # Ranked by |p(root)| in each root's own chart (both charts share
    # the normalized coefficient scale), NOT by grid position: f32
    # coefficient noise can flag spurious sign changes in several
    # cells, and index-order compaction could displace genuine roots
    # past slot R while a residual ordering keeps them first.
    R = 12
    cs = jnp.stack([coeffs_a, coeffs_b], axis=0)  # (2,...,11)
    resid = jnp.zeros_like(roots_ab)
    for k in range(cs.shape[-1] - 1, -1, -1):  # Horner, static unroll
        resid = resid * roots_ab + cs[..., k][..., None]
    res_all = jnp.concatenate([jnp.abs(resid[0]), jnp.abs(resid[1])], axis=-1)
    big = jnp.asarray(jnp.finfo(res_all.dtype).max, res_all.dtype)
    order = jnp.argsort(jnp.where(valid, res_all, big), axis=-1, stable=True)
    order = order[..., :R]
    z_all = jnp.take_along_axis(z_all, order, axis=-1)
    valid = jnp.take_along_axis(valid, order, axis=-1)

    # --- per root: null vector of C(z*) → (x,y).
    # Fixing the "1"-monomial coordinate m[9]=1 turns the null-vector
    # problem into a 9-var least squares C[:,:9]·m' = −C[:,9], solved by
    # normal equations — the same finite-(x,y) chart the previous
    # eigh-based version assumed when it divided by m[9], with a
    # batched 9×9 solve in place of an iterative 10×10 eigh (this
    # kernel runs n_hyp×R times per RANSAC call).
    def per_root(z):
        C = _c_of_z(polys, z)  # (...,10,10)
        A = C[..., :, :9]
        rhs = -C[..., :, 9]
        ata = jnp.einsum("...ij,...ik->...jk", A, A)
        atb = jnp.einsum("...ij,...i->...j", A, rhs)
        scale = jnp.maximum(jnp.trace(ata, axis1=-2, axis2=-1), 1e-30)
        reg = (1e-7 if ata.dtype == jnp.float32 else 1e-13) * scale
        ata = ata + reg[..., None, None] * jnp.eye(9, dtype=ata.dtype)
        m = jnp.linalg.solve(ata, atb[..., None])[..., 0]
        return m[..., 7], m[..., 8]

    zt = jnp.moveaxis(z_all, -1, 0)  # (R,...)
    xs, ys = jax.vmap(per_root)(zt)  # (R,...)
    xyz1 = jnp.stack([xs, ys, zt, jnp.ones_like(zt)], axis=-1)  # (R,...,4)
    E = jnp.einsum("...ec,r...c->r...e", basis, xyz1)  # (R,...,9)
    E = jnp.moveaxis(E, 0, -2)  # (...,R,9)
    E = E.reshape(E.shape[:-1] + (3, 3))
    norm = jnp.linalg.norm(E.reshape(E.shape[:-2] + (9,)), axis=-1)
    E = E / jnp.maximum(norm, 1e-12)[..., None, None]
    return E, valid


def essential_geometric_error(E: jnp.ndarray, x1: jnp.ndarray, x2: jnp.ndarray) -> jnp.ndarray:
    """Symmetric squared epipolar transfer error (reference
    essential.h:15-20 applied both ways, stereo.cpp:52-58):
    r²/|l1|² + r²/|l2|² with r = x2ᵀ E x1. E (...,3,3), x1/x2 (...,N,3)."""
    Ex1 = jnp.einsum("...ij,...nj->...ni", E, x1)
    Etx2 = jnp.einsum("...ji,...nj->...ni", E, x2)
    r = jnp.sum(x2 * Ex1, axis=-1)
    n1 = jnp.sum(Ex1[..., :2] ** 2, axis=-1)
    n2 = jnp.sum(Etx2[..., :2] ** 2, axis=-1)
    return r * r / jnp.maximum(n1, 1e-18) + r * r / jnp.maximum(n2, 1e-18)


def decompose_essential(E: jnp.ndarray):
    """SVD decomposition into (R1, R2, T) with ±T implied
    (reference essential.cpp:267-287). Batched."""
    U, _, Vt = jnp.linalg.svd(E)
    U = U * jnp.sign(jnp.linalg.det(U))[..., None, None]
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))[..., None, None]
    W = jnp.asarray([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    T = U[..., :, 2]
    return R1, R2, T
