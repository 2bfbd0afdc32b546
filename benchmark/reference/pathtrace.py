"""Plain PyTorch reference of the forward path-tracing render, for chosen
pixels of a frame.

It recomputes, from the scene's host arrays alone, what the renderer
computes for a pixel: the pinhole camera's primary ray, then per bounce the
closest hit (brute force over every triangle, with the watertight Woop pair
test and its per-triangle tolerance), the winner's barycentrics and shading
normal, the modified-Phong BSDF sample with the nested-dielectric priority
stack (Schlick reflectance, Snell refraction, total internal reflection), the
light-tree next-event direction with its MIS mixture pdf (the emitters'
radix tree over Morton codes, node importance |energy| / distance^2, the
dense pick by inverse CDF and the pdf summed over every emitter), emission,
and the throughput update.  The arithmetic follows the renderer's expressions
in their order, so that on the same uniforms the same path comes out; only
the closest-hit query differs in method (every triangle instead of a tile
walk).  It covers untextured scenes without sub-surface scattering, media or
a sky image, with at most 512 emitters (the renderer's dense light regime).

The uniforms are the frame's own: a frame seeded with `seed` on `device`
draws, per sample, (2, W*H) lens uniforms, then per bounce (8, W*H) path
uniforms, and this module draws the same numbers from a generator seeded
alike and keeps the columns of the chosen pixels.

`dtype` is the precision the reference computes in: float32 is the
reference, a lower one (bfloat16) the control that the check has to refuse.
It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SMALL_EPS = 1e-5
MAX_PHONG_N_S = 1.0e6
VACUUM_PRIORITY = 9999999
VACUUM_IOR = 1.0
STACK_SIZE = 8
DENSE_MAX = 512
N_UNIFORMS = 8
NULL_MAT, EMPTY_SLOT = -1, -2
_INF = 3.4e38
_TINY = 1e-12
_SPLIT = 4097.0
_PAIRS_PER_STEP = 1 << 24  # ray x triangle pairs per step of the brute-force hit


# ---------------------------------------------------------------------------
# vector helpers
# ---------------------------------------------------------------------------

def dot(a, b, keepdims=False):
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def length(v, keepdims=False):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdims))


def normalize(v, eps=0.0):
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    if eps > 0.0:
        inv = torch.where(n2 > eps * eps, 1.0 / torch.sqrt(torch.clamp(n2, min=eps * eps)),
                          torch.zeros_like(n2))
        return v * inv
    return v / torch.sqrt(n2)


def de_nan(v):
    return torch.where(torch.isfinite(v), v, torch.zeros_like(v))


def reflect(v, n):
    return v - 2.0 * dot(v, n, keepdims=True) * n


def onb_from_z(z):
    zu = normalize(z)
    zx, zy, zz = zu[..., 0], zu[..., 1], zu[..., 2]
    use_x = torch.abs(zx) > torch.abs(zy)
    inv_a = 1.0 / torch.sqrt(torch.where(use_x, zx * zx + zz * zz, zy * zy + zz * zz))
    zero = torch.zeros_like(zx)
    x = torch.where(use_x[..., None], torch.stack([zz, zero, -zx], dim=-1),
                    torch.stack([zero, -zz, zy], dim=-1)) * inv_a[..., None]
    return x, normalize(cross(zu, x)), zu


def safe_sqrt(x):
    return torch.where(x > _TINY, torch.sqrt(torch.clamp(x, min=_TINY)), torch.zeros_like(x))


def safe_pow(base, exp):
    exp = torch.as_tensor(exp, dtype=base.dtype, device=base.device)
    out = torch.pow(torch.clamp(base, min=_TINY), exp)
    at_zero = torch.where(exp == 0.0, torch.ones_like(out), torch.zeros_like(out))
    return torch.where(base > _TINY, out, at_zero)


# ---------------------------------------------------------------------------
# sampling, pdfs, Phong filters
# ---------------------------------------------------------------------------

def n_s_too_large(n):
    return (torch.abs(n - MAX_PHONG_N_S) < SMALL_EPS) | (n >= MAX_PHONG_N_S)


def sample_hemisphere_cos(u1, u2):
    z = torch.sqrt(torch.clamp(1.0 - u2, min=0.0))
    phi = 2.0 * math.pi * u1
    r = torch.sqrt(torch.clamp(u2, min=0.0))
    return normalize(torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, z], dim=-1), SMALL_EPS)


def sample_phong_lobe(n, u1, u2):
    mirror = n_s_too_large(n)
    n_safe = torch.where(mirror, torch.ones_like(n), n)
    r1 = torch.clamp(u1, min=1e-12)
    z = torch.pow(r1, 1.0 / (n_safe + 1.0))
    s = torch.sqrt(torch.clamp(1.0 - torch.pow(r1, 2.0 / (n_safe + 1.0)), min=0.0))
    phi = 2.0 * math.pi * u2
    v = normalize(torch.stack([s * torch.cos(phi), s * torch.sin(phi), z], dim=-1), SMALL_EPS)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device).expand_as(v)
    return torch.where(mirror[..., None], up, v)


def generate_direction(main_dir, normal, phong, n, u1, u2):
    """A cosine-hemisphere sample about `normal`, or where `phong` a Phong
    lobe sample about `main_dir`, in world space."""
    local = torch.where(phong[..., None], sample_phong_lobe(n, u1, u2),
                        sample_hemisphere_cos(u1, u2))
    x, y, z = onb_from_z(torch.where(phong[..., None], main_dir, normal))
    return normalize(local[..., 0:1] * x + local[..., 1:2] * y + local[..., 2:3] * z)


def diffuse_sampling_pdf(normal, out_dir):
    return torch.clamp(dot(normal, out_dir) / math.pi, min=0.0)


def _same_side(d1, d2):
    return ((d1 >= 0) & (d2 >= 0)) | ((d1 <= 0) & (d2 <= 0))


def _opposite_side(d1, d2):
    return ((d1 >= 0) & (d2 <= 0)) | ((d1 <= 0) & (d2 >= 0))


def specular_pdf(in_dir, out_dir, normal, perfect_out, n, refracted):
    """The Phong lobe's solid-angle pdf (n+1) cos^n / 2 pi, gated by the
    hemisphere the ray leaves into; MAX_PHONG_N_S / 2 pi at the mirror limit."""
    d1 = dot(in_dir, normal)
    d2 = dot(normal, out_dir)
    valid = torch.where(refracted, _same_side(d1, d2), _opposite_side(d1, d2))
    mirror = n_s_too_large(n)
    n_safe = torch.where(mirror, torch.ones_like(n), n)
    cos_a = torch.clamp(dot(perfect_out, out_dir), min=0.0)
    lobe = (n_safe + 1.0) * safe_pow(cos_a, n_safe) / (2.0 * math.pi)
    pdf = torch.where(mirror, torch.full_like(lobe, MAX_PHONG_N_S / (2.0 * math.pi)), lobe)
    return torch.where(valid, pdf, torch.zeros_like(pdf))


def scattering_pdf(normal, next_dir, diffuse, coming_dir, refracted):
    diff_val = torch.clamp(dot(normal, next_dir), min=0.0)
    d1 = dot(coming_dir, normal)
    d2 = dot(next_dir, normal)
    spec_ok = torch.where(refracted, _same_side(d1, d2), _opposite_side(d1, d2))
    return torch.where(diffuse, diff_val, spec_ok.to(diff_val.dtype))


def schlick(cos_theta, n_1, n_2):
    r0 = torch.square((n_1 - n_2) / (n_1 + n_2))
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    return r0 + (1.0 - r0) * m * m * m * m * m


def phong_filter(k, n, ideal_dir, out_dir):
    """k (n+2)/2 cos^n; k MAX_PHONG_N_S / 2 at the mirror limit."""
    mirror = n_s_too_large(n)
    n_safe = torch.where(mirror, torch.ones_like(n), n)
    cos_a = torch.clamp(dot(ideal_dir, out_dir, keepdims=True), min=0.0)
    w = (n_safe[..., None] + 2.0) * safe_pow(cos_a, n_safe[..., None]) / 2.0
    w = torch.where(mirror[..., None], torch.full_like(w, MAX_PHONG_N_S / 2.0), w)
    return k * w


# ---------------------------------------------------------------------------
# watertight triangle test (the light pdf and the winner's barycentrics)
# ---------------------------------------------------------------------------

def _two_product(a, b):
    p = a * b
    a1 = a * _SPLIT
    a_hi = a1 - (a1 - a)
    a_lo = a - a_hi
    b1 = b * _SPLIT
    b_hi = b1 - (b1 - b)
    b_lo = b - b_hi
    return p, ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo


def _exact_diff(a, b, c, d):
    p1, e1 = _two_product(a, b)
    p2, e2 = _two_product(c, d)
    return (p1 - p2) + (e1 - e2)


def _edge_len(a, b):
    d = a - b
    return torch.sqrt(torch.sum(d * d, dim=-1))


def triangle_tolerance(p):
    d12 = _edge_len(p[..., 0, :], p[..., 1, :])
    d13 = _edge_len(p[..., 0, :], p[..., 2, :])
    d23 = _edge_len(p[..., 1, :], p[..., 2, :])
    return torch.clamp(torch.minimum(d12, torch.minimum(d13, d23)) / 100.0, max=1e-5)


def triangle_area(p):
    s1 = _edge_len(p[..., 0, :], p[..., 1, :])
    s2 = _edge_len(p[..., 0, :], p[..., 2, :])
    s3 = _edge_len(p[..., 1, :], p[..., 2, :])
    s = (s1 + s2 + s3) / 2.0
    return torch.abs(torch.sqrt(torch.clamp(s * (s - s1) * (s - s2) * (s - s3), min=0.0)))


def _permute3(v0, v1, v2, kz):
    is0, is1 = kz == 0, kz == 1
    return (torch.where(is0, v1, torch.where(is1, v2, v0)),
            torch.where(is0, v2, torch.where(is1, v0, v1)),
            torch.where(is0, v0, torch.where(is1, v1, v2)))


def intersect_tris(origin, direction, tri_p, tol):
    """Each ray against its K triangles (..., K, 3, 3): (t, bary, hit)."""
    pt = tri_p - origin[..., None, None, :]
    kz = torch.argmax(torch.abs(direction), dim=-1)
    dx, dy, dz = _permute3(direction[..., 0], direction[..., 1], direction[..., 2], kz)
    px, py, pz = _permute3(pt[..., 0], pt[..., 1], pt[..., 2], kz[..., None, None])
    sx, sy, sz = (-dx / dz)[..., None, None], (-dy / dz)[..., None, None], (1.0 / dz)[..., None, None]
    x = px + sx * pz
    y = py + sy * pz
    x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2]
    y1, y2, y3 = y[..., 0], y[..., 1], y[..., 2]
    e1 = x2 * y3 - y2 * x3
    e2 = x3 * y1 - y3 * x1
    e3 = x1 * y2 - y1 * x2
    exact = (e1 == 0.0) | (e2 == 0.0) | (e3 == 0.0)
    e1 = torch.where(exact, _exact_diff(x2, y3, y2, x3), e1)
    e2 = torch.where(exact, _exact_diff(x3, y1, y3, x1), e2)
    e3 = torch.where(exact, _exact_diff(x1, y2, y1, x2), e3)
    mixed = ((e1 < 0) | (e2 < 0) | (e3 < 0)) & ((e1 > 0) | (e2 > 0) | (e3 > 0))
    det = e1 + e2 + e3
    zs = pz * sz[..., 0:1]
    ts = e1 * zs[..., 0] + e2 * zs[..., 1] + e3 * zs[..., 2]
    inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    t = ts * inv_det
    bary = torch.stack([e1 * inv_det, e2 * inv_det, e3 * inv_det], dim=-1)
    hit = (~mixed) & (det != 0.0) & (t <= float("inf")) & (t >= tol)
    return torch.where(hit, t, torch.full_like(t, float("inf"))), bary, hit


# ---------------------------------------------------------------------------
# the closest hit, brute force
# ---------------------------------------------------------------------------

def _pair_t(o, d, v, tol):
    """The Woop pair test of rays (B, 1) against triangles (1, T): the
    candidate t and whether the line meets the triangle at or above its
    tolerance.  `v` is nine (1, T) rows: v1xyz v2xyz v3xyz."""
    ax, ay, az = torch.abs(d[0]), torch.abs(d[1]), torch.abs(d[2])
    is2 = (az >= ax) & (az >= ay)
    is1 = (~is2) & (ay >= ax)
    is0 = ~(is1 | is2)

    def perm(vx, vy, vz):
        return (torch.where(is0, vy, torch.where(is1, vz, vx)),
                torch.where(is0, vz, torch.where(is1, vx, vy)),
                torch.where(is0, vx, torch.where(is1, vy, vz)))

    dx, dy, dz = perm(*d)
    sx, sy, sz = -dx / dz, -dy / dz, 1.0 / dz

    def corner(c):
        px, py, pz = perm(v[3 * c] - o[0], v[3 * c + 1] - o[1], v[3 * c + 2] - o[2])
        return px + sx * pz, py + sy * pz, pz * sz

    x1, y1, z1 = corner(0)
    x2, y2, z2 = corner(1)
    x3, y3, z3 = corner(2)
    e1 = x2 * y3 - y2 * x3
    e2 = x3 * y1 - y3 * x1
    e3 = x1 * y2 - y1 * x2
    mixed = ((e1 < 0) | (e2 < 0) | (e3 < 0)) & ((e1 > 0) | (e2 > 0) | (e3 > 0))
    det = e1 + e2 + e3
    t = (e1 * z1 + e2 * z2 + e3 * z3) * (1.0 / torch.where(det == 0.0, 1.0, det))
    return t, (~mixed) & (det != 0.0) & (t >= tol)


def closest_hit(geom, origin, direction, live):
    """(winner index or -1, hit) of every ray over every triangle: the
    smallest t at or above the triangle's tolerance, the lowest index (the
    lowest Morton rank) on a tie.  Dead rays miss without work."""
    r = origin.shape[0]
    dev = origin.device
    win = torch.full((r,), -1, dtype=torch.int64, device=dev)
    rows = torch.nonzero(live).squeeze(1)
    n_tris = geom.p.shape[0]
    step = max(1, _PAIRS_PER_STEP // n_tris)
    v = [geom.p[:, c // 3, c % 3][None, :] for c in range(9)]
    tol = geom.tol[None, :]
    lane = torch.arange(n_tris, device=dev)
    inf = torch.tensor(_INF, dtype=origin.dtype, device=dev)
    for r0 in range(0, rows.shape[0], step):
        idx = rows[r0:r0 + step]
        o = [origin[idx, c][:, None] for c in range(3)]
        d = [direction[idx, c][:, None] for c in range(3)]
        t, ok = _pair_t(o, d, v, tol)
        t = torch.where(ok & (t < inf), t, inf)
        t_min = torch.amin(t, dim=1, keepdim=True)
        k = torch.amin(torch.where(t == t_min, lane, n_tris), dim=1)
        win[idx] = torch.where(t_min[:, 0] < inf, k, -1)
    return win, win >= 0


# ---------------------------------------------------------------------------
# the scene
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Geometry:
    p: torch.Tensor  # (T, 3, 3)
    n: torch.Tensor  # (T, 3, 3)
    tol: torch.Tensor  # (T,)
    mat: torch.Tensor  # (T,) int64


@dataclasses.dataclass
class Materials:
    kd: torch.Tensor
    ks: torch.Tensor
    ke: torch.Tensor
    tf: torch.Tensor
    n_s: torch.Tensor  # +inf: the mirror limit of a transparent material
    n_i: torch.Tensor
    t_r: torch.Tensor
    priority: torch.Tensor  # int64


@dataclasses.dataclass
class Lights:
    """The emitters' radix tree: nodes 0 .. E-2 internal (0 the root), node
    E-1+k leaf k in Morton order."""

    tri_p: torch.Tensor  # (E, 3, 3) leaf order
    tri_n: torch.Tensor
    area: torch.Tensor
    tol: torch.Tensor
    center: torch.Tensor  # (2E-1, 3) node box centres
    energy: torch.Tensor  # (2E-1, 3)
    centroid: torch.Tensor  # (2E-1, 3), 0 on internal nodes
    avg_normal: torch.Tensor  # (2E-1, 3), 0 on internal nodes
    is_leaf: torch.Tensor  # (2E-1,)
    sib: torch.Tensor  # (2E-1,) sibling (the root: itself)
    anc: torch.Tensor  # (2E-1, E): 1 where the node is on the root-to-leaf path


@dataclasses.dataclass
class Scene:
    geom: Geometry
    mats: Materials
    lights: Lights | None


def _expand_bits(v):
    v = v.astype(np.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    return (v * 0x00000005) & 0x49249249


def _morton(centers):
    lo = centers.min(axis=0)
    span = np.maximum(centers.max(axis=0) - lo, np.float32(1e-12))
    q = np.clip((centers - lo) / span * np.float32(1024.0), 0.0, 1023.0).astype(np.int64)
    return (_expand_bits(q[:, 0]) * 4 + _expand_bits(q[:, 1]) * 2 + _expand_bits(q[:, 2])) \
        & 0xFFFFFFFF


def _radix_tree(codes):
    """Children of the binary radix tree over sorted 30-bit codes, equal codes
    split by their index bits: {node: (left, right)} with internal nodes
    numbered in preorder from 0 and leaf k as n-1+k."""
    n = codes.shape[0]
    keys = [(int(c) << 32) | i for i, c in enumerate(codes)]  # code, then index
    children = {}
    counter = [0]

    def build(first, last):
        if first == last:
            return n - 1 + first
        node = counter[0]
        counter[0] += 1
        common = 64 - (keys[first] ^ keys[last]).bit_length()
        split, step = first, last - first
        while step > 1:
            step = (step + 1) // 2
            cand = split + step
            if cand < last and 64 - (keys[first] ^ keys[cand]).bit_length() > common:
                split = cand
        if step == 1 and split == first and split + 1 < last and \
                64 - (keys[first] ^ keys[split + 1]).bit_length() > common:
            split += 1
        children[node] = (build(first, split), build(split + 1, last))
        return node

    build(0, n - 1)
    return children


def _light_tree(p, n, energy, dev, dt):
    """The dense light tree over the emitters (host arrays in scene order)."""
    e = p.shape[0]
    pmin, pmax = p.min(axis=1), p.max(axis=1)
    order = np.argsort(_morton(np.float32(0.5) * (pmin + pmax)), kind="stable")
    p, n, energy = p[order], n[order], energy[order]
    total = 2 * e - 1
    lo = np.zeros((total, 3), np.float32)
    hi = np.zeros((total, 3), np.float32)
    node_energy = np.zeros((total, 3), np.float32)
    lo[e - 1:], hi[e - 1:], node_energy[e - 1:] = pmin[order], pmax[order], energy
    sib = np.arange(total)
    parent = np.full(total, -1)
    children = _radix_tree(np.sort(_morton(np.float32(0.5) * (pmin + pmax)), kind="stable")) \
        if e > 1 else {}
    for node in sorted(children, reverse=True):  # children before parents (preorder ids)
        a, b = children[node]
        lo[node], hi[node] = np.minimum(lo[a], lo[b]), np.maximum(hi[a], hi[b])
        node_energy[node] = node_energy[a] + node_energy[b]
        sib[a], sib[b] = b, a
        parent[a] = parent[b] = node
    anc = np.zeros((total, e), np.float32)
    for k in range(e):
        node = e - 1 + k
        while node >= 0:
            anc[node, k] = 1.0
            node = parent[node]
    t = lambda a: torch.as_tensor(a, device=dev).to(dt)  # noqa: E731
    tri_p, tri_n = t(p), t(n)
    zeros = torch.zeros((e - 1, 3), dtype=dt, device=dev)
    return Lights(
        tri_p=tri_p, tri_n=tri_n, area=triangle_area(tri_p), tol=triangle_tolerance(tri_p),
        center=0.5 * (t(lo) + t(hi)), energy=t(node_energy),
        centroid=torch.cat([zeros, torch.mean(tri_p, dim=1)]),
        avg_normal=torch.cat([zeros, normalize(torch.mean(tri_n, dim=1), SMALL_EPS)]),
        is_leaf=torch.arange(total, device=dev) >= e - 1,
        sib=torch.as_tensor(sib, device=dev), anc=t(anc))


def build_scene(arrays: dict, device, dtype=torch.float32) -> Scene:
    """The reference's scene from the host arrays of `scene_input.read_scene`."""
    m = arrays["materials"]
    if np.any(np.asarray(m["path_length"]) > 0):
        raise ValueError("the reference renders no sub-surface scattering")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)  # noqa: E731
    tri_p = np.asarray(arrays["tri_p"], np.float32)
    mat = np.asarray(arrays["mat_idx"], np.int64)
    # triangles in the Morton order of their box centres (stable), so that the
    # lowest index wins an exact tie as the lowest slot of the renderer's
    # sorted rows does
    rank = np.argsort(_morton(np.float32(0.5) * (tri_p.min(axis=1) + tri_p.max(axis=1))),
                      kind="stable")
    p = t(tri_p[rank])
    geom = Geometry(p=p, n=t(np.asarray(arrays["tri_n"], np.float32)[rank]),
                    tol=triangle_tolerance(p), mat=torch.as_tensor(mat[rank], device=device))
    n_s, t_r = t(m["n_s"]), t(m["t_r"])
    mats = Materials(
        kd=t(m["kd"]), ks=t(m["ks"]), ke=t(m["ke"]), tf=t(m["tf"]),
        n_s=torch.where((n_s >= MAX_PHONG_N_S) & (t_r > 0), float("inf"), n_s),
        n_i=t(m["n_i"]), t_r=t_r,
        priority=torch.as_tensor(np.asarray(m["priority"], np.int64), device=device))

    # emitters: a vertex's emission above the triangle's tolerance; energy
    # 2 pi avg(Ke) area
    ke_verts = np.repeat(np.asarray(m["ke"], np.float32)[mat][:, None, :], 3, axis=1)
    tol32 = triangle_tolerance(torch.as_tensor(tri_p)).numpy()
    emissive = (np.linalg.norm(ke_verts, axis=-1) > tol32[:, None]).any(axis=1)
    lights = None
    if emissive.any():
        idx = np.nonzero(emissive)[0]
        if idx.shape[0] > DENSE_MAX:
            raise ValueError(f"{idx.shape[0]} emitters: the reference covers at most {DENSE_MAX}")
        area = triangle_area(torch.as_tensor(tri_p[idx])).numpy()
        energy = (2.0 * np.pi * ke_verts[idx].mean(axis=1) * area[:, None]).astype(np.float32)
        lights = _light_tree(tri_p[idx], np.asarray(arrays["tri_n"], np.float32)[idx], energy,
                             device, dtype)
    return Scene(geom=geom, mats=mats, lights=lights)


# ---------------------------------------------------------------------------
# materials and the dielectric stack
# ---------------------------------------------------------------------------

def _take(table, mat_id):
    return table[torch.clamp(mat_id, min=0)]


def _priority(mats, mat_id):
    return torch.where(mat_id < 0, VACUUM_PRIORITY, _take(mats.priority, mat_id))


def _ior(mats, mat_id):
    return torch.where(mat_id < 0, VACUUM_IOR, _take(mats.n_i, mat_id))


def _phong_exponent(mats, mat_id):
    n_s = _take(mats.n_s, mat_id)
    inf = torch.isinf(n_s)
    filt = torch.where(inf, 0.0, n_s)[..., None] / math.sqrt(3.0)
    v = torch.ones(mat_id.shape + (3,), dtype=filt.dtype, device=filt.device) * filt
    return torch.where(inf, float("inf"), torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1),
                                                                min=1e-30)))


def _transmission_k(mats, mat_id):
    k = _take(mats.tf, mat_id) * _take(mats.t_r, mat_id)[..., None]
    return torch.where((mat_id < 0)[..., None], 1.0, k)


def stack_init(r, device):
    ids = torch.full((r, STACK_SIZE), EMPTY_SLOT, dtype=torch.int64, device=device)
    ids[:, 0] = NULL_MAT
    return ids, torch.ones((r,), dtype=torch.int64, device=device)


def _stack_add(ids, length, mat_id, enable):
    slots = torch.arange(STACK_SIZE, device=ids.device)
    valid = slots < length[..., None]
    present = torch.any(valid & (ids == mat_id[..., None]), dim=-1)
    do = enable & ~present & (length < STACK_SIZE)
    ids = torch.where(do[..., None] & (slots == length[..., None]), mat_id[..., None], ids)
    return ids, length + do.long()


def _stack_remove(ids, length, mat_id, enable):
    slots = torch.arange(STACK_SIZE, device=ids.device)
    match = (slots < length[..., None]) & (ids == mat_id[..., None])
    sel = torch.amax(torch.where(match, slots, -1), dim=-1)
    found = (sel >= 0) & enable
    shifted = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], EMPTY_SLOT)], dim=-1)
    ids = torch.where(found[..., None] & (slots >= sel[..., None]), shifted, ids)
    length = length - found.long()
    return torch.where(found[..., None] & (slots >= length[..., None]), EMPTY_SLOT, ids), length


def stack_rearrange(ids, length, mat_id, false_hit, entering, refracted, enable):
    push = enable & ((false_hit & entering) | (~false_hit & refracted & entering))
    pop = enable & ((false_hit & ~entering) | (~false_hit & refracted & ~entering))
    ids, length = _stack_add(ids, length, mat_id, push)
    return _stack_remove(ids, length, mat_id, pop)


def highest_prioritised(mats, ids, length):
    """(highest, second-highest)-priority ids on the stack: the lowest value
    wins, ties go to the highest slot; the second is strictly lower-priority
    than the first and strictly above vacuum."""
    size = STACK_SIZE
    slots = torch.arange(size, device=ids.device)
    valid = slots < length[..., None]
    pri = torch.where(valid, _priority(mats, ids), VACUUM_PRIORITY + 1)
    key = pri * (size + 1) + (size - 1 - slots)
    min_key = torch.amin(key, dim=-1)
    hp_pri = min_key // (size + 1)
    hp = torch.where(hp_pri >= VACUUM_PRIORITY, NULL_MAT,
                     torch.sum(torch.where(key == min_key[..., None], ids, 0), dim=-1))
    eligible = valid & (pri > hp_pri[..., None]) & (pri < VACUUM_PRIORITY)
    key2 = torch.where(eligible, key, 2**31 - 1)
    min2 = torch.amin(key2, dim=-1)
    shp = torch.where(torch.any(eligible, dim=-1),
                      torch.sum(torch.where((key2 == min2[..., None]) & eligible, ids, 0), dim=-1),
                      NULL_MAT)
    return hp, shp


def _snell(v_in, normal, cos1, sin_ratio, sign):
    sin1 = safe_sqrt(1.0 - cos1 * cos1)
    v_perp = sign[..., None] * cos1[..., None] * normal
    v_par = v_in - v_perp
    sin2 = sin_ratio * sin1
    cos2 = safe_sqrt(1.0 - sin2 * sin2)
    tan2 = sin2 / torch.clamp(cos2, min=1e-20)
    straight = torch.abs(tan2) <= SMALL_EPS
    inv_tan = torch.where(straight, 0.0, 1.0 / torch.clamp(tan2, min=SMALL_EPS))
    v_out = normalize(v_par + sign[..., None] * inv_tan[..., None] * length(v_par, True) * normal,
                      SMALL_EPS)
    return torch.where(straight[..., None], sign[..., None] * normal, v_out)


def sample_bsdf(mats, mat_id, v_in, normal, stack_ids, stack_len, u):
    """The BSDF sample at a hit: a dict of the next direction, the filter and
    the flags the path needs (false hit, refraction, opaque branches all
    evaluated and blended)."""
    u_choice, u_pick, u1, u2 = u[0], u[1], u[2], u[3]
    ones = torch.ones(mat_id.shape, dtype=v_in.dtype, device=v_in.device)
    yes = torch.ones(mat_id.shape, dtype=torch.bool, device=v_in.device)
    hp, shp = highest_prioritised(mats, stack_ids, stack_len)
    false_hit = _priority(mats, mat_id) > _priority(mats, hp)
    n_i = _take(mats.n_i, mat_id)
    t_r = _take(mats.t_r, mat_id)
    transparent = t_r > 0
    n_s = _phong_exponent(mats, mat_id)
    d_in_n = dot(v_in, normal)
    entering_geom = d_in_n <= 0

    hp_ior, shp_ior = _ior(mats, hp), _ior(mats, shp)
    cos_in = -d_in_n
    refract_in = u_choice >= schlick(cos_in, hp_ior, n_i)
    v_refr_in = _snell(v_in, normal, cos_in, hp_ior / n_i, -ones)
    v_refl_in = normalize(reflect(v_in, normal), SMALL_EPS)
    cos_out = d_in_n
    sin_out = safe_sqrt(1.0 - cos_out * cos_out)
    reflect_out = (sin_out >= shp_ior / n_i) | (u_choice <= schlick(cos_out, n_i, shp_ior))
    v_refr_out = _snell(v_in, normal, cos_out, n_i / shp_ior, ones)
    v_refl_out = normalize(reflect(v_in, -normal), SMALL_EPS)
    refracted_t = torch.where(entering_geom, refract_in, ~reflect_out)
    v_out_t = torch.where(entering_geom[..., None],
                          torch.where(refract_in[..., None], v_refr_in, v_refl_in),
                          torch.where(reflect_out[..., None], v_refl_out, v_refr_out))
    entering_t = entering_geom & refract_in
    next_t = torch.where(entering_geom, torch.where(refract_in, mat_id, hp),
                         torch.where(reflect_out, mat_id, shp))

    dir_t = generate_direction(v_out_t, normal, yes, n_s, u1, u2)
    k_t = _take(mats.tf, mat_id) * t_r[..., None]
    filt_t = phong_filter(k_t, n_s, v_out_t, dir_t)
    has_next2 = (next_t >= 0) & (next_t != mat_id)
    k2 = _transmission_k(mats, next_t)
    n_s2 = _phong_exponent(mats, next_t)
    filt_t = torch.where(has_next2[..., None], filt_t * phong_filter(k2, n_s2, v_out_t, dir_t),
                         filt_t)
    k_t = torch.where(has_next2[..., None], k_t * k2, k_t)

    kd, ks = _take(mats.kd, mat_id), _take(mats.ks, mat_id)
    kd_len, ks_len = length(kd), length(ks)
    denom = kd_len + ks_len
    spec_prob = torch.where(denom > 0, ks_len / torch.clamp(denom, min=1e-20), 1.0)
    choose_spec = u_pick <= spec_prob
    dir_diff = generate_direction(torch.zeros_like(v_in), normal, ~yes, ones, u1, u2)
    refl_dir = normalize(reflect(v_in, normal), SMALL_EPS)
    dir_spec = generate_direction(refl_dir, normal, yes, n_s, u1, u2)
    filt_spec = phong_filter(ks, n_s, refl_dir, dir_spec)
    cs = choose_spec[..., None]
    dir_o = torch.where(cs, dir_spec, dir_diff)
    filt_o = torch.where(cs, filt_spec, kd)
    k_o = torch.where(cs, ks, kd)
    n_o = torch.where(choose_spec, n_s, 1.0)

    use_refr = ~false_hit & transparent
    use_opaque = ~false_hit & ~transparent
    fh, ur = false_hit[..., None], use_refr[..., None]
    return dict(
        dir=torch.where(fh, v_in, torch.where(ur, dir_t, dir_o)),
        perfect=torch.where(ur, v_out_t, torch.where(cs, refl_dir, normal)),
        filter=torch.where(fh, 1.0, torch.where(ur, filt_t, filt_o)),
        k=torch.where(fh, 1.0, torch.where(ur, k_t, k_o)),
        n=torch.where(false_hit, 1.0, torch.where(use_refr, n_s, n_o)),
        diffuse=use_opaque & ~choose_spec,
        reflected=torch.where(use_refr, ~refracted_t, use_opaque & choose_spec),
        refracted=false_hit | (use_refr & refracted_t),
        false_hit=false_hit,
        entering=torch.where(false_hit, entering_geom, use_refr & entering_t),
    )


# ---------------------------------------------------------------------------
# next-event direction with the light tree and the MIS mixture pdf
# ---------------------------------------------------------------------------

def _importance(lt, node, point, pivot):
    """|energy| / distance^2 of every node (a leaf's energy directed toward
    the point): (R, 3) -> (R, 2E-1); `node` permutes the node tables."""
    d = point[..., None, :] - lt.center[node]
    dist2 = torch.clamp(torch.sum(d * d, dim=-1), min=1e-30)
    dtp = normalize(point[..., None, :] - lt.centroid[node], SMALL_EPS)
    fac = torch.clamp(dot(lt.avg_normal[node], dtp) * dot(-dtp, pivot[..., None, :]), min=0.0)
    eff = torch.where(lt.is_leaf[node][..., None], lt.energy[node] * fac[..., None],
                      lt.energy[node])
    return length(eff) / dist2


def leaf_pdfs(lt, point, pivot):
    """Each leaf's selection pdf: the product of its path's branch ratios."""
    e = lt.tri_p.shape[0]
    if e == 1:
        return torch.ones(point.shape[:-1] + (1,), dtype=point.dtype, device=point.device)
    nodes = torch.arange(2 * e - 1, device=point.device)
    imp = _importance(lt, nodes, point, pivot)
    ratio = imp / (imp + _importance(lt, lt.sib, point, pivot))
    ratio = torch.where(torch.isfinite(ratio), ratio, 0.5)
    ratio = torch.where(nodes == 0, 1.0, ratio)
    return torch.exp(torch.log(torch.clamp(ratio, 1e-35, 1.0)) @ lt.anc)


def nee_mis(lt, rec, normal, coming_dir, weight, u):
    pivot = torch.where(rec["diffuse"][..., None], normal, rec["perfect"])
    w = torch.where(torch.isinf(rec["n"]), 0.0, weight)
    take_light = u[0] < w
    pdfs = leaf_pdfs(lt, rec["origin"], pivot)
    cdf = torch.cumsum(pdfs, dim=-1)
    leaf = torch.clamp(torch.sum(cdf < u[1].reshape(-1, 1) * cdf[..., -1:], dim=-1),
                       0, lt.tri_p.shape[0] - 1)
    s = torch.sqrt(torch.clamp(u[2], min=0.0))
    a, b = 1.0 - s, u[3] * s
    p = lt.tri_p[leaf]
    target = a[..., None] * p[..., 0, :] + b[..., None] * p[..., 1, :] + \
        (1.0 - a - b)[..., None] * p[..., 2, :]
    light_dir = normalize(target - rec["origin"], SMALL_EPS)
    new_dir = torch.where(take_light[..., None], light_dir, rec["dir"])
    refilter = take_light & (rec["reflected"] | rec["refracted"])
    new_filter = torch.where(refilter[..., None],
                             phong_filter(rec["k"], rec["n"], pivot, new_dir), rec["filter"])

    t, bary, hit = intersect_tris(rec["origin"], new_dir, lt.tri_p[None], lt.tol[None])
    n_hit = normalize(torch.sum(bary[..., None] * lt.tri_n[None], dim=-2), SMALL_EPS)
    cos = torch.abs(dot(new_dir[..., None, :], n_hit))
    geom = torch.where(hit, (t * t) / torch.clamp(cos * lt.area[None, :], min=1e-20), 0.0)
    hittable = torch.sum(pdfs * geom, dim=-1)
    samp = torch.where(rec["diffuse"], diffuse_sampling_pdf(normal, new_dir),
                       specular_pdf(coming_dir, new_dir, normal, rec["perfect"], rec["n"],
                                    rec["refracted"]))
    pdf = w * hittable + (1.0 - w) * samp
    scat = scattering_pdf(normal, new_dir, rec["diffuse"], coming_dir, rec["refracted"])
    factor = scat / math.pi / torch.where(pdf != 0, pdf, 1.0)
    return new_dir, new_filter, torch.where(pdf != 0, factor, 0.0)


# ---------------------------------------------------------------------------
# paths and pixels
# ---------------------------------------------------------------------------

def trace_paths(scene, origin, direction, uniforms, weight):
    """Radiance (R, 3) of rays (R, 3) over len(uniforms) bounces, each bounce
    taking its (8, R) uniforms."""
    r = origin.shape[0]
    dev, dt = origin.device, origin.dtype
    g, mats, lt = scene.geom, scene.mats, scene.lights
    stack_ids, stack_len = stack_init(r, dev)
    o, d = origin, direction
    mask = torch.ones((r, 3), dtype=dt, device=dev)
    acc = torch.zeros((r, 3), dtype=dt, device=dev)
    live = torch.ones((r,), dtype=torch.bool, device=dev)
    for u in uniforms:
        win, hit = closest_hit(g, o, d, live)
        hit = hit & live
        s = torch.clamp(win, min=0)
        _, bary, _ = intersect_tris(o, d, g.p[s][:, None], g.tol[s][:, None])
        b = torch.where(hit[:, None], bary[:, 0], 0.0)[..., None]
        point = torch.sum(b * g.p[s], dim=-2)
        normal = normalize(torch.sum(b * g.n[s], dim=-2), SMALL_EPS)
        mat_id = g.mat[s]
        rec = sample_bsdf(mats, mat_id, d, normal, stack_ids, stack_len, u[0:4])
        rec["origin"] = point
        if lt is not None:
            do_nee = hit & ~rec["false_hit"]
            new_dir, new_filter, nee_factor = nee_mis(lt, rec, normal, d, weight, u[4:8])
            next_dir = torch.where(do_nee[..., None], new_dir, rec["dir"])
            filt = torch.where(do_nee[..., None], new_filter, rec["filter"])
            factor = torch.where(do_nee, nee_factor, 1.0)
        else:
            next_dir, filt = rec["dir"], rec["filter"]
            factor = torch.ones((r,), dtype=dt, device=dev)
        emit = _take(mats.ke, mat_id)
        real_hit = hit & ~rec["false_hit"]
        acc = acc + torch.where(real_hit[..., None], de_nan(mask * emit), 0.0)
        cont = factor > 0
        new_mask = torch.where((real_hit & cont)[..., None],
                               mask * filt * torch.clamp(factor, 0.0, 0.9999)[..., None], mask)
        live = live & hit & (rec["false_hit"] | cont)
        mask = new_mask
        stack_ids, stack_len = stack_rearrange(stack_ids, stack_len, mat_id, rec["false_hit"],
                                               rec["entering"], rec["refracted"], hit)
        o = torch.where(hit[..., None], point, o)
        d = torch.where(hit[..., None], next_dir, d)
    return de_nan(acc)


def camera_rays(cam: dict, width: int, height: int, pix, dev, dt):
    """Pinhole primary rays of pixels `pix` (row-major indices): (origin,
    direction), each (K, 3)."""
    eye = torch.as_tensor(cam["eye"], dtype=torch.float32)
    center = torch.as_tensor(cam["center"], dtype=torch.float32)
    up = torch.as_tensor(cam["up"], dtype=torch.float32)
    w = normalize(eye - center)
    u = normalize(cross(up, w))
    v = cross(w, u)
    tan_y = math.tan(math.pi * cam["fovy_deg"] / 180.0 / 2.0)
    f32 = lambda x: float(torch.tensor(x, dtype=torch.float32))  # noqa: E731
    tan_x, tan_y = f32((width / height) * tan_y), f32(tan_y)
    focus = f32(cam.get("focus_dist", 1.0))
    eye, u, v, w = (x.to(dev).to(dt) for x in (eye, u, v, w))
    i = (pix // width).to(dt) + 0.5
    j = (pix % width).to(dt) + 0.5
    alpha = tan_x * (j - width / 2.0) / (width / 2.0)
    beta = tan_y * (height / 2.0 - i) / (height / 2.0)
    d = normalize(alpha[..., None] * u + beta[..., None] * v - w)
    point = eye + focus * d
    origin = torch.broadcast_to(eye, d.shape)
    return origin, normalize(point - origin)


def render_pixels(scene, cam: dict, traffic: dict, seed: int, pix: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """(K, 3) float32 radiance of the frame's pixels `pix`, averaged over
    its samples, from the uniforms a frame seeded with `seed` draws on the
    device of `pix`."""
    w_, h_ = traffic["width"], traffic["height"]
    n = w_ * h_
    dev = pix.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    samples = traffic["spp"] * traffic["dof_sample_size"]
    if traffic.get("aperture", 0.0):
        raise ValueError("the reference renders pinhole cameras only")
    origin, direction = camera_rays(cam, w_, h_, pix, dev, dtype)
    total = 0.0
    for _ in range(samples):
        torch.rand((2, n), generator=gen, device=dev)  # the lens sample: no lens
        uniforms = [torch.rand((N_UNIFORMS, n), generator=gen, device=dev)[:, pix].to(dtype)
                    for _ in range(traffic["level"])]
        total = total + de_nan(trace_paths(scene, origin, direction, uniforms,
                                           traffic["hittable_pdf_weight"]))
    return (total / samples).float()
