"""Frozen copy of the port's textured street world (`ya_vo_tpu_torch/utils/
scene.py`, with `utils/synthetic.kitti_camera` and the camera's `K`), the
benchmark's traffic generator. Copied verbatim but for the imports, so a
world built and rendered here equals the port's module array for array
(`vo_bench/tests/test_vo_bench_frozen.py`); it imports nothing of the
port, so later changes to the program leave the benchmark's frames as
they are.

Conventions: world frame = first camera frame (x right, y DOWN, z
forward); poses are world->camera 4x4.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class Camera(NamedTuple):
    """Pinhole intrinsics as float32-rounded Python floats."""

    fx: float
    fy: float
    cx: float
    cy: float

    @staticmethod
    def create(fx, fy, cx, cy) -> "Camera":
        return Camera(*(float(np.float32(x)) for x in (fx, fy, cx, cy)))

    def K(self, device=None) -> torch.Tensor:
        """3x3 float32 intrinsic matrix on `device`."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
             [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)


def kitti_camera() -> Camera:
    """The KITTI gray-camera intrinsics (KITTI odometry calib, P0)."""
    return Camera.create(718.856, 718.856, 607.1928, 185.2157)


CAM_HEIGHT = 1.65          # KITTI gray camera height above road (m)

# quads intersected together: [QUAD_CHUNK, H, W] float32 intermediates
QUAD_CHUNK = 16


# --------------------------------------------------------------------------
# texture atlas
# --------------------------------------------------------------------------
def make_texture(size: int = 2048, seed: int = 0,
                 photo: Optional[np.ndarray] = None) -> np.ndarray:
    """[size, size] float32 texture in [0, 255].

    Multi-octave value noise (fractal detail at every scale so FAST finds
    corners at any viewing distance) + high-contrast speckle rectangles +
    one deliberately REPEATED pattern band (adjacent copies of the same
    patch: descriptor-matching ambiguity, like repeated windows on a real
    facade). If `photo` (a real grayscale image, uint8) is given, random
    crops of it are blended into the atlas so surfaces carry real
    photographic texture.
    """
    rng = np.random.default_rng(seed)
    tex = np.zeros((size, size), np.float32)
    amp = 1.0
    for cells in (8, 16, 32, 64, 128, 256, 512, 1024):
        if cells > size:
            break
        g = rng.normal(0.0, 1.0, (cells + 1, cells + 1)).astype(np.float32)
        # bilinear upsample grid to full size
        ys = np.linspace(0, cells, size, endpoint=False)
        xs = np.linspace(0, cells, size, endpoint=False)
        y0 = ys.astype(int); x0 = xs.astype(int)
        fy = (ys - y0)[:, None]; fx = (xs - x0)[None, :]
        up = (g[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
              + g[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
              + g[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
              + g[np.ix_(y0 + 1, x0 + 1)] * fy * fx)
        tex += amp * up
        amp *= 0.8            # slow decay: real surfaces are rough at
        #                       every scale; fast decay gave a blurry world
        #                       FAST found ~50 corners/frame in
    tex += 0.6 * rng.normal(0.0, 1.0, tex.shape).astype(np.float32)
    tex = (tex - tex.mean()) / (tex.std() + 1e-6)
    tex = 128.0 + 46.0 * tex

    # speckle rectangles: sharp high-contrast corners at the FAST scale
    # (gravel, windows, road markings, signage)
    n_speckle = (size * size) // 350
    ys = rng.integers(0, size - 8, n_speckle)
    xs = rng.integers(0, size - 8, n_speckle)
    hs = rng.integers(1, 7, n_speckle)
    ws = rng.integers(1, 7, n_speckle)
    vals = rng.uniform(10, 245, n_speckle).astype(np.float32)
    for y, x, h, w, v in zip(ys, xs, hs, ws, vals):
        tex[y:y + h, x:x + w] = v

    # repeated band: the SAME 48x48 patch tiled 12x in one strip — a
    # realistic picket-fence/facade-window ambiguity. (A full-atlas-width
    # band made ~30% of the visible ground identical tiles; LK then locks
    # onto the wrong copy en masse — photometrically perfect, so only the
    # pose solve can reject it — and the inlier gate trips. Real repeated
    # texture exists at THIS scale, not that one.)
    patch = tex[:48, :48].copy()
    row = size - 64
    for x in range(0, min(12 * 48, size - 48), 48):
        tex[row:row + 48, x:x + 48] = patch

    if photo is not None:
        ph = np.asarray(photo, np.float32)
        for _ in range(12):
            ch = int(min(ph.shape[0], rng.integers(128, 256)))
            cw = int(min(ph.shape[1], rng.integers(128, 384)))
            sy = rng.integers(0, ph.shape[0] - ch + 1)
            sx = rng.integers(0, ph.shape[1] - cw + 1)
            dy = rng.integers(0, size - ch)
            dx = rng.integers(0, size - cw)
            tex[dy:dy + ch, dx:dx + cw] = ph[sy:sy + ch, sx:sx + cw]

    return np.clip(tex, 2.0, 253.0).astype(np.float32)


def _mip_pyramid(tex: np.ndarray, levels: int = 5):
    """2x2-average mip chain for minification anti-aliasing (distant
    surfaces would otherwise alias/flicker frame to frame, which no real
    camera does — lens + sensor integrate)."""
    pyr = [tex]
    cur = tex
    for _ in range(levels - 1):
        cur = 0.25 * (cur[0::2, 0::2] + cur[0::2, 1::2]
                      + cur[1::2, 0::2] + cur[1::2, 1::2])
        pyr.append(cur.astype(np.float32))
    return pyr


# --------------------------------------------------------------------------
# world building
# --------------------------------------------------------------------------
class Quads(NamedTuple):
    """Packed textured quads. A point on quad q is
    origin[q] + a * e1[q] + b * e2[q], (a, b) in [0, 1]^2; its texture
    coordinate is atlas[q, 0:2] + (a, b) * atlas[q, 2:4] (texels)."""

    origin: np.ndarray   # [Q, 3] float32
    e1: np.ndarray       # [Q, 3]
    e2: np.ndarray       # [Q, 3]
    atlas: np.ndarray    # [Q, 4] (u0, v0, du, dv) texels
    valid: np.ndarray    # [Q] bool


def curved_trajectory(n_frames: int, step: float = 0.8,
                      segments=((0.0, 200),), seed: int = 0,
                      speed_jitter: float = 0.15) -> np.ndarray:
    """[F, 4, 4] world->camera poses along a piecewise-curved street path.

    `segments` = ((yaw_rate_rad_per_frame, n_frames), ...) cycled until
    n_frames; per-frame speed jitter models accelerations. Ground truth for
    ATE; also feeds `build_street_world` so the geometry follows the road.
    """
    rng = np.random.default_rng(seed)
    rates = []
    while len(rates) < n_frames:
        for rate, n in segments:
            rates.extend([rate] * n)
    rates = np.asarray(rates[:n_frames])

    poses = np.zeros((n_frames, 4, 4), np.float32)
    yaw = 0.0
    pos = np.zeros(3)
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        R_cw = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        poses[i, :3, :3] = R_cw.T
        poses[i, :3, 3] = -R_cw.T @ pos
        poses[i, 3, 3] = 1.0
        v = step * (1.0 + speed_jitter * rng.standard_normal())
        pos = pos + R_cw @ np.array([0.0, 0.0, max(0.1, v)])
        yaw += rates[i]
    return poses


def camera_centers(poses_wc: np.ndarray) -> np.ndarray:
    R = poses_wc[:, :3, :3]
    t = poses_wc[:, :3, 3]
    return -np.einsum("fij,fi->fj", R, t)


def build_street_world(poses_wc: np.ndarray, seed: int = 0,
                       tex_size: int = 2048,
                       road_half_width: float = 7.0,
                       wall_offset: float = 8.0,
                       wall_height: float = 6.0,
                       tile_len: float = 10.0,
                       billboard_every: float = 14.0,
                       texel_density: float = 48.0) -> Quads:
    """Generate the street-corridor geometry along a camera path: ground
    tiles, left/right facade walls, and occluding billboards, each with a
    random atlas rect (texel density ~constant so texture frequency scales
    correctly with distance)."""
    rng = np.random.default_rng(seed + 1)
    centers = camera_centers(poses_wc)
    # resample path by arc length
    seg = np.diff(centers, axis=0)
    seg_len = np.linalg.norm(seg[:, [0, 2]], axis=1)
    s_cum = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = float(s_cum[-1])

    def path_at(s):
        # linear extrapolation beyond both ends (the world must extend WELL
        # past the last camera pose, or the far field turns to featureless
        # sky and tracking starves into a reset storm — observed directly:
        # 8 resets/60 frames with a world ending 30 m out vs 1 with 120 m)
        i = np.searchsorted(s_cum, s) - 1
        i = np.clip(i, 0, len(seg) - 1)
        f = (s - s_cum[i]) / max(seg_len[i], 1e-6)
        p = centers[i] + f * seg[i]
        tdir = seg[i] / max(np.linalg.norm(seg[i]), 1e-9)
        return p, tdir

    origins, e1s, e2s, rects = [], [], [], []

    def rect_for(w_m: float, h_m: float):
        du = min(int(w_m * texel_density), tex_size - 2)
        dv = min(int(h_m * texel_density), tex_size - 2)
        u0 = rng.integers(0, tex_size - du)
        v0 = rng.integers(0, tex_size - dv)
        return [u0, v0, du, dv]

    def add_quad(origin, e1, e2):
        origins.append(origin)
        e1s.append(e1)
        e2s.append(e2)
        rects.append(rect_for(np.linalg.norm(e1), np.linalg.norm(e2)))

    # start the world slightly behind the first camera
    s = -tile_len
    ground_y = CAM_HEIGHT
    while s < total + 120.0:
        p, tdir = path_at(s)
        lat = np.array([tdir[2], 0.0, -tdir[0]])   # 90 deg right of tangent
        fwd = tdir * (tile_len + 1.0)              # overlap hides seams
        base = np.array([p[0], ground_y, p[2]])
        # ground: two half-width tiles (distinct texture left/right of lane)
        add_quad(base - lat * road_half_width, lat * road_half_width, fwd)
        add_quad(base, lat * road_half_width, fwd)
        # facade walls
        up = np.array([0.0, -wall_height, 0.0])
        add_quad(base - lat * wall_offset, fwd, up)
        add_quad(base + lat * wall_offset, fwd, up)
        s += tile_len

    # billboards/occluders along the roadside
    s = 6.0
    while s < total + 100.0:
        p, tdir = path_at(s)
        lat = np.array([tdir[2], 0.0, -tdir[0]])
        side = rng.choice([-1.0, 1.0])
        off = rng.uniform(2.5, 5.5)
        w = rng.uniform(1.2, 3.0)
        h = rng.uniform(1.5, 3.5)
        base = np.array([p[0], ground_y, p[2]]) + lat * (side * off)
        # face across the road, tilted a little
        face = lat * (-side) + tdir * rng.uniform(-0.3, 0.3)
        face = face / np.linalg.norm(face)
        edge = np.array([face[2], 0.0, -face[0]]) * w
        add_quad(base - edge * 0.5, edge, np.array([0.0, -h, 0.0]))
        s += billboard_every * rng.uniform(0.7, 1.4)

    Q = len(origins)
    return Quads(
        origin=np.asarray(origins, np.float32),
        e1=np.asarray(e1s, np.float32),
        e2=np.asarray(e2s, np.float32),
        atlas=np.asarray(rects, np.float32),
        valid=np.ones(Q, bool),
    )


def cull_quads(quads: Quads, pose_wc: np.ndarray, q_max: int,
               z_near: float = -15.0, z_far: float = 140.0) -> Quads:
    """Host-side per-frame culling: keep the q_max nearest quads whose
    center lies in the camera's z range, padded to static shape."""
    R = pose_wc[:3, :3]
    t = pose_wc[:3, 3]
    c = quads.origin + 0.5 * quads.e1 + 0.5 * quads.e2
    pc = c @ R.T + t
    ok = quads.valid & (pc[:, 2] > z_near) & (pc[:, 2] < z_far) \
        & (np.abs(pc[:, 0]) < 80.0)
    idx = np.nonzero(ok)[0]
    order = np.argsort(pc[idx, 2])
    idx = idx[order][:q_max]
    n = len(idx)
    pad = q_max - n

    def pk(a, fill=0.0):
        out = np.concatenate([a[idx], np.full((pad,) + a.shape[1:], fill,
                                              a.dtype)], axis=0)
        return out

    return Quads(
        origin=pk(quads.origin), e1=pk(quads.e1), e2=pk(quads.e2),
        atlas=pk(quads.atlas),
        valid=np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
    )


# --------------------------------------------------------------------------
# renderer
# --------------------------------------------------------------------------
def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array onto `device` with no wait for the card's queue
    (through pinned memory on the card)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _dot3(a, b):
    """sum_k a[k] * b[k] for two 3-sequences, as float32 multiply-adds."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(v1, v2):
    """[Q, 3] x [Q, 3] -> [Q, 3]."""
    x1, y1, z1 = v1.unbind(-1)
    x2, y2, z2 = v2.unbind(-1)
    return torch.stack([y1 * z2 - z1 * y2, z1 * x2 - x1 * z2,
                        x1 * y2 - y1 * x2], dim=-1)


def render_frame(
    origin, e1, e2, atlas, valid, mips, pose_wc, K_inv,
    *, height: int, width: int, ss: int = 1,
    gain: float = 1.0, bias: float = 0.0, noise_sigma: float = 1.5,
    noise_key: Optional[int] = None,
) -> torch.Tensor:
    """Ray-cast one frame. Returns uint8 [height, width] on the device of
    `pose_wc`.

    origin, e1, e2 [Q, 3], atlas [Q, 4], valid [Q] (bool): the culled
    quads; mips: tuple of [S/2^l, S/2^l] texture mip levels (trilinear-
    selected by the screen-space texel footprint); pose_wc [4, 4]; K_inv
    [3, 3]. `noise_key` is the integer seed of the sensor noise (None: no
    noise).
    """
    dev = pose_wc.device
    f32 = torch.float32
    H, W = height * ss, width * ss
    R = pose_wc[:3, :3]
    t = pose_wc[:3, 3]
    # camera centre -R^T t and the per-pixel ray R^T d_cam, written out
    cw = [-_dot3(R[:, j], t) for j in range(3)]

    vv = ((torch.arange(H, dtype=f32, device=dev) + 0.5) / ss - 0.5)[:, None]
    uu = ((torch.arange(W, dtype=f32, device=dev) + 0.5) / ss - 0.5)[None, :]
    d_cam = [(uu * K_inv[k, 0] + vv * K_inv[k, 1]) + K_inv[k, 2]
             for k in range(3)]                          # 3 x [H, W]
    d_w = [_dot3(d_cam, R[:, j]) for j in range(3)]      # 3 x [H, W]

    # per-quad scalars [Q]
    Q = origin.shape[0]
    n = _cross(e1, e2)
    oc = origin - torch.stack(cw)                        # o - cw [Q, 3]
    on = _dot3(oc.unbind(-1), n.unbind(-1))
    co1 = _dot3((-oc).unbind(-1), e1.unbind(-1))         # (cw - o) . v1
    co2 = _dot3((-oc).unbind(-1), e2.unbind(-1))
    inv_v1 = 1.0 / torch.clamp(_dot3(e1.unbind(-1), e1.unbind(-1)), min=1e-9)
    inv_v2 = 1.0 / torch.clamp(_dot3(e2.unbind(-1), e2.unbind(-1)), min=1e-9)

    big = 1e9
    bt = torch.full((H, W), big, dtype=f32, device=dev)
    ba = torch.zeros((H, W), dtype=f32, device=dev)
    bb = torch.zeros((H, W), dtype=f32, device=dev)
    bqi = torch.full((H, W), -1, dtype=torch.int64, device=dev)

    def per_quad(x):                                     # [C] -> [C, 1, 1]
        return x[:, None, None]

    for c0 in range(0, Q, QUAD_CHUNK):
        sl = slice(c0, min(c0 + QUAD_CHUNK, Q))
        nq = [per_quad(x) for x in n[sl].unbind(-1)]
        v1 = [per_quad(x) for x in e1[sl].unbind(-1)]
        v2 = [per_quad(x) for x in e2[sl].unbind(-1)]
        denom = _dot3(d_w, nq)                           # [C, H, W]
        denom = torch.where(denom.abs() < 1e-9, 1e-9, denom)
        tt = per_quad(on[sl]) / denom
        a = (per_quad(co1[sl]) + tt * _dot3(d_w, v1)) * per_quad(inv_v1[sl])
        b = (per_quad(co2[sl]) + tt * _dot3(d_w, v2)) * per_quad(inv_v2[sl])
        z = tt * d_cam[2]
        good = (per_quad(valid[sl]) & (z > 0.2) & (a >= 0.0) & (a <= 1.0)
                & (b >= 0.0) & (b <= 1.0))
        tt_m = torch.where(good, tt, big)
        # the chunk's nearest hit, the earliest quad on ties (argmin takes
        # the first minimum); then a strict < against the earlier chunks
        ct, ci = tt_m.min(dim=0)
        win = ct < bt
        bt = torch.where(win, ct, bt)
        ba = torch.where(win, a.gather(0, ci[None])[0], ba)
        bb = torch.where(win, b.gather(0, ci[None])[0], bb)
        bqi = torch.where(win, ci + c0, bqi)

    hit = bqi >= 0
    qi = torch.clamp(bqi, min=0)
    den_q = atlas[:, 2] * torch.sqrt(inv_v1)             # texel density [Q]
    brect = atlas[qi]                                    # [H, W, 4]
    bden = den_q[qi]

    # texture coords (level 0 texels) + lod from the texel footprint:
    # screen px covers (t / fx_eff) meters -> t * density / fx texels
    tu = brect[..., 0] + ba * brect[..., 2]
    tv = brect[..., 1] + bb * brect[..., 3]
    fx_eff = ss / K_inv[0, 0]
    n_mips = len(mips)
    lod = torch.log2(torch.clamp(bt * bden / fx_eff, min=1e-6))
    lod = torch.clamp(lod, 0.0, n_mips - 1.001)
    l0i = torch.floor(lod).to(torch.int64)
    frac = lod - l0i
    l1i = torch.clamp(l0i + 1, max=n_mips - 1)

    # trilinear mip sampling against ONE flattened texture: per pixel only
    # the two adjacent levels matter, 2 levels x 4 bilinear taps
    sizes = _upload(np.array([m.shape[0] for m in mips], np.int64), dev)
    level_off = _upload(np.concatenate(
        [[0], np.cumsum([m.numel() for m in mips])])[:-1].astype(np.int64),
        dev)
    flat_tex = torch.cat([m.reshape(-1) for m in mips])

    def sample(li):
        scale = torch.exp2(-li.to(f32))
        S = sizes[li]                                    # [H, W] int64
        Sf = S.to(f32)
        u = torch.minimum(torch.clamp(tu * scale, min=0.0), Sf - 1.001)
        v = torch.minimum(torch.clamp(tv * scale, min=0.0), Sf - 1.001)
        u0 = torch.floor(u)
        v0 = torch.floor(v)
        fu = u - u0
        fv = v - v0
        idx = level_off[li] + v0.to(torch.int64) * S + u0.to(torch.int64)
        t00 = flat_tex[idx]
        t01 = flat_tex[idx + 1]
        t10 = flat_tex[idx + S]
        t11 = flat_tex[idx + S + 1]
        return (t00 * (1 - fu) * (1 - fv) + t01 * fu * (1 - fv)
                + t10 * (1 - fu) * fv + t11 * fu * fv)

    val = (1.0 - frac) * sample(l0i) + frac * sample(l1i)

    # sky: smooth vertical gradient (nearly featureless, like real sky)
    elev = d_cam[1]                                      # y down: sky is <0
    sky = 205.0 + 28.0 * torch.clamp(elev, -1.0, 0.3)
    img = torch.where(hit, val, sky)

    if ss > 1:
        img = img.reshape(height, ss, width, ss).mean(dim=(1, 3))

    # illumination + vignette + sensor noise
    cyy, cxx = (height - 1) / 2.0, (width - 1) / 2.0
    vg_v = (torch.arange(height, dtype=f32, device=dev) - cyy) / cyy
    vg_u = (torch.arange(width, dtype=f32, device=dev) - cxx) / cxx
    r2 = vg_v[:, None] ** 2 + vg_u[None, :] ** 2
    img = img * gain * (1.0 - 0.18 * r2 / 2.0) + bias
    if noise_key is not None:
        gen = torch.Generator(device=dev).manual_seed(int(noise_key))
        img = img + noise_sigma * torch.randn(img.shape, generator=gen,
                                              device=dev)
    return torch.clamp(img, 0, 255).to(torch.uint8)


# --------------------------------------------------------------------------
# sequence driver
# --------------------------------------------------------------------------
class TexturedSequence:
    """Iterable of rendered frames over a procedurally built street world.

    Renders on demand on `device` (default: the CUDA card; raises when
    there is none; pass device="cpu" to render on the CPU). The mips live
    on the device; culling stays on the host. Ground-truth trajectory in
    `.poses`. Illumination drifts sinusoidally with `light_period`.
    """

    def __init__(self, n_frames: int = 100, height: int = 376,
                 width: int = 1241, step: float = 0.8,
                 segments=((0.0, 80), (0.006, 60), (0.0, 80), (-0.008, 50)),
                 seed: int = 0, q_max: int = 64, tex_size: int = 2048,
                 photo: Optional[np.ndarray] = None, ss: int = 1,
                 light_period: float = 400.0, light_amp: float = 0.12,
                 cam: Optional[Camera] = None,
                 mip_levels: int = 5, noise_sigma: float = 1.5,
                 device=None):
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the renderer runs on the card by default; "
                "pass device='cpu' to render on the CPU")
        self.n_frames = n_frames
        self.height, self.width = height, width
        self.poses = curved_trajectory(n_frames, step=step,
                                       segments=segments, seed=seed)
        self.cam = cam if cam is not None else kitti_camera()
        self.quads = build_street_world(self.poses, seed=seed,
                                        tex_size=tex_size)
        tex = make_texture(tex_size, seed=seed, photo=photo)
        self.mips = tuple(torch.as_tensor(m).to(self.device)
                          for m in _mip_pyramid(tex, mip_levels))
        K = np.asarray(self.cam.K(), np.float64)
        self.K_inv = np.linalg.inv(K).astype(np.float32)
        self.q_max = q_max
        self.ss = ss
        self.seed = seed
        self.light_period = light_period
        self.light_amp = light_amp
        self.noise_sigma = noise_sigma

    def frame(self, f: int) -> torch.Tensor:
        """Frame `f`: uint8 [height, width] on the sequence's device."""
        culled = cull_quads(self.quads, self.poses[f], self.q_max)
        gain = 1.0 + self.light_amp * np.sin(
            2 * np.pi * f / self.light_period)
        bias = 6.0 * np.sin(2 * np.pi * f / (self.light_period * 1.7))
        # one upload a frame: the culled quads, the pose and K^-1 packed
        Q = self.q_max
        packed = np.concatenate([
            culled.origin.ravel(), culled.e1.ravel(), culled.e2.ravel(),
            culled.atlas.ravel(), culled.valid.astype(np.float32),
            self.poses[f].ravel(), self.K_inv.ravel()]).astype(np.float32)
        d = _upload(packed, self.device)
        parts = torch.split(d, [3 * Q, 3 * Q, 3 * Q, 4 * Q, Q, 16, 9])
        return render_frame(
            parts[0].view(Q, 3), parts[1].view(Q, 3), parts[2].view(Q, 3),
            parts[3].view(Q, 4), parts[4] > 0.5, self.mips,
            parts[5].view(4, 4), parts[6].view(3, 3),
            height=self.height, width=self.width, ss=self.ss,
            gain=float(gain), bias=float(bias),
            noise_sigma=self.noise_sigma,
            noise_key=self.seed * 1000003 + f,
        )

    def __len__(self):
        return self.n_frames

    def __iter__(self):
        for f in range(self.n_frames):
            yield self.frame(f)
