"""A synthetic aerial flight strip, rendered on the device from a seed.

The scene model is the one of the port's ``data/synthetic.py``: a tilted
plane ``z = a x + b y`` carrying a band-limited RGB texture (24 sinusoids per
channel of random frequency, direction and phase), photographed by
downward-looking pinhole cameras; every pixel is the exact ray/plane
intersection, so multi-view photo-consistency and ground-truth depth are
analytic. Here the cameras fly a straight strip along world x at a fixed
forward overlap, and the seed draws the texture only: the geometry, the
sizes and so the work are the same for every seed.

Images are quantised to 8 bits and normalised per image and channel (mean 0,
variance 1), as the loaders hand them to the models. Projection matrices are
``K [R | t]`` in the XrightYdown convention, one per stage with the first
two rows divided by 2^(3-k).
"""

from __future__ import annotations

import math

import numpy as np
import torch

COMPONENTS = 24


class Strip:
    """Cameras and texture of one strip. ``scene`` holds the parameters of
    a traffic mix's ``scene`` entry (focal length, flight height, frame
    size, forward overlap, plane slopes, texture band in rad per pixel)."""

    def __init__(self, scene: dict, seed: int, device):
        self.p = scene
        self.device = torch.device(device)
        self.H, self.W = scene["frame_rows"], scene["frame_cols"]
        self.f = float(scene["focal_px"])
        self.height = float(scene["flight_height_m"])
        gsd = self.height / self.f
        # frames step along world x by (1 - overlap) of a frame's ground width
        self.spacing = (1.0 - scene["forward_overlap"]) * self.W * gsd
        g = torch.Generator(device=self.device).manual_seed(int(seed))
        lo, hi = scene["texture_rad_per_px"]
        u = torch.rand((3, 3, COMPONENTS), generator=g, device=self.device, dtype=torch.float64)
        freq = (lo + (hi - lo) * u[0]) / gsd  # rad per metre
        ang, self.phase = 2 * math.pi * u[1], 2 * math.pi * u[2]
        self.fx, self.fy = freq * torch.cos(ang), freq * torch.sin(ang)

    def camera(self, pos: float, rows: int, cols: int, row0: float = 0.0, col0: float = 0.0):
        """(K [3,3], R [3,3], centre [3]) float64 of the nadir camera at
        ``pos`` frames along the strip, imaging ``rows`` x ``cols`` pixels
        whose first pixel is the full frame's (row0, col0)."""
        K = np.array([[self.f, 0.0, self.W / 2 - col0], [0.0, self.f, self.H / 2 - row0],
                      [0.0, 0.0, 1.0]])
        R = np.diag([1.0, -1.0, -1.0])  # x right, y down, looking down
        return K, R, np.array([pos * self.spacing, 0.0, self.height])

    def render(self, cam, rows: int, cols: int):
        """(image uint8-valued float32 [rows,cols,3], depth float32
        [rows,cols]) of ``cam`` on the device."""
        K, R, c = (torch.as_tensor(a, dtype=torch.float64, device=self.device) for a in cam)
        a, b = self.p["plane_slope"]
        v, u = torch.meshgrid(torch.arange(rows, dtype=torch.float64, device=self.device),
                              torch.arange(cols, dtype=torch.float64, device=self.device),
                              indexing="ij")
        d_cam = torch.stack([u, v, torch.ones_like(u)], -1) @ torch.linalg.inv(K).T
        d_w = d_cam @ R  # R^T d_cam, row-vector form
        t = (a * c[0] + b * c[1] - c[2]) / (d_w[..., 2] - a * d_w[..., 0] - b * d_w[..., 1])
        x, y = c[0] + t * d_w[..., 0], c[1] + t * d_w[..., 1]
        scale = math.sqrt(2.0 / COMPONENTS)
        chans = []
        for ch in range(3):
            arg = (x[..., None] * self.fx[ch] + y[..., None] * self.fy[ch] + self.phase[ch])
            chans.append(0.5 + 0.3 * scale * torch.sin(arg).sum(-1))
        img = torch.clamp(torch.stack(chans, -1) * 255.0, 0, 255).floor()
        return img.float(), t.float()  # camera-frame z = t, since d_cam has z = 1

    @staticmethod
    def center(img: torch.Tensor) -> torch.Tensor:
        """Per-image, per-channel mean 0 and variance 1 (the loaders' centring)."""
        x = img.double()
        mean = x.mean(dim=(0, 1), keepdim=True)
        var = x.var(dim=(0, 1), keepdim=True, unbiased=False)
        return ((x - mean) / (var.sqrt() + 1e-8)).float()

    @staticmethod
    def proj(cam) -> np.ndarray:
        K, R, c = cam
        P = np.eye(4)
        P[:3, :3] = R
        P[:3, 3] = -R @ c
        P[:3] = K @ P[:3]
        return P.astype(np.float32)


def stage_projs(projs: np.ndarray, stages: int = 3) -> dict:
    """{"stageK": [..., 4, 4]} with rows 0 and 1 divided by 2^(stages-k)."""
    out = {}
    for k in range(1, stages + 1):
        p = projs.copy()
        p[..., :2, :] /= 2 ** (stages - k)
        out[f"stage{k}"] = p
    return out


def predict_items(strip: Strip, items: int, views: int) -> list[dict]:
    """``items`` work items of full frames: item i takes frame i + 2 as its
    reference and its ``views - 1`` nearest neighbours along the strip as
    sources (two before, two after for 5 views), as numpy arrays: ``imgs``
    [V,H,W,3] float32, ``proj_matrices`` {"stageK": [V,4,4]}. Every frame is
    rendered once on the device; the items are assembled on the host."""
    half = (views - 1) // 2
    frames, projs = [], []
    for i in range(items + 2 * half):
        cam = strip.camera(i, strip.H, strip.W)
        img, _ = strip.render(cam, strip.H, strip.W)
        frames.append(strip.center(img).cpu().numpy())
        projs.append(strip.proj(cam))
    out = []
    for i in range(items):
        r = i + half
        order = [r] + sorted((j for j in range(i, i + 2 * half + 1) if j != r),
                             key=lambda j: (abs(j - r), j))
        out.append({"imgs": np.stack([frames[j] for j in order]),
                    "proj_matrices": stage_projs(np.stack([projs[j] for j in order]))})
    return out


def train_batches(strip: Strip, count: int, batch: int, views: int, rows: int, cols: int,
                  depth_range, num_depth: int, seed: int) -> list[dict]:
    """``count`` batches of ``batch`` crops, ``rows`` x ``cols`` each, as the
    training loader hands them over (numpy): every crop at its own place
    along the strip and in the frame, drawn from ``seed``; the source crops
    of a view are centred on the ground point under the reference crop's
    centre. GT depth at the three stage resolutions (the full crop,
    subsampled by 2 and 4) and masks where it lies in the depth range."""
    g = torch.Generator().manual_seed(int(seed) + 7)
    dmin, dmax = depth_range
    half = (views - 1) // 2
    nbrs = sorted((j for j in range(-half, half + 1) if j), key=lambda j: (abs(j), j))
    out = []
    for _ in range(count):
        imgs, projs, gts = [], [], []
        for _ in range(batch):
            pos, fr, fc = torch.rand(3, generator=g, dtype=torch.float64).tolist()
            pos = 4.0 * pos
            row0, col0 = fr * (strip.H - rows), fc * (strip.W - cols)
            ref = strip.camera(pos, rows, cols, row0, col0)
            img, depth = strip.render(ref, rows, cols)
            # the ground point under the crop's centre, at its rendered depth
            K, R, c = ref
            zc = float(depth[rows // 2, cols // 2])
            ground = c + R.T @ (np.linalg.inv(K) @ np.array([cols / 2, rows / 2, 1.0]) * zc)
            views_ = [strip.center(img)]
            projs_ = [strip.proj(ref)]
            for j in nbrs:
                K0, R0, c0 = strip.camera(pos + j, strip.H, strip.W)
                uvw = K0 @ (R0 @ (ground - c0))
                u, v = uvw[0] / uvw[2], uvw[1] / uvw[2]
                cam = strip.camera(pos + j, rows, cols, v - rows / 2, u - cols / 2)
                views_.append(strip.center(strip.render(cam, rows, cols)[0]))
                projs_.append(strip.proj(cam))
            imgs.append(torch.stack(views_))
            projs.append(np.stack(projs_))
            gts.append(depth)
        gt = torch.stack(gts).cpu().numpy()
        depth = {"stage1": gt[:, ::4, ::4], "stage2": gt[:, ::2, ::2], "stage3": gt}
        out.append({
            "imgs": torch.stack(imgs).cpu().numpy(),
            "proj_matrices": stage_projs(np.stack(projs)),
            "depth_values": np.array([[dmin, dmax, (dmax - dmin) / num_depth]] * batch,
                                     np.float32),
            "depth": {k: np.ascontiguousarray(v) for k, v in depth.items()},
            "mask": {k: ((v >= dmin) & (v <= dmax)).astype(np.float32) for k, v in depth.items()},
            "depth_interval": np.full((batch,), (dmax - dmin) / num_depth, np.float32),
        })
    return out
