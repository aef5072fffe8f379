"""Closed-loop quality experiment: train -> infer -> eval on synthetic 4D.

Counterpart of ``actionmesh_tpu/training/closed_loop.py``. The system is
scored without any download: procedurally deforming scenes with exact
tracked ground truth are rendered, encoded through a frozen conditioning
stack (a tiny DINOv2 and the posterior mean of a tiny TripoSG VAE), the
Stage-I denoiser and Stage-II decoder train on held-in scenes, the real
{video + 3D} (or video -> 4D) pipeline runs on held-out scenes from the
exported checkpoints, and the ActionBench harness scores its output meshes.

  1. Scenes: an ellipsoid family (anisotropic breathing, bend, bounded
     translation) whose tracked ground truth is exact by construction.
  2. Data: RGBA renders (the native rasterizer), per-frame latents from the
     frozen VAE's mean encode, per-frame DINOv2 context, as inference
     builds them.
  3. Train: rectified flow (Stage I) and masked position MSE (Stage II);
     the Stage-0 phase trains the VAE on exact TSDF and the DiT on the
     trained VAE's anchor latents.
  4. Infer and 5. Eval: the pipeline's own output meshes, scored by ICP +
     chamfer + motion chamfer against the scenes' ground truth.

The frozen stack is drawn from the spec's seeds with torch generators on
the device, so its numbers differ from JAX's; every function that uses it
also takes one built elsewhere (``stack``). Frames are PNG files written
and read by the port's own codec (``io/png.py``). A scene is skipped only
when the video -> 4D path's Stage 0 gives a degenerate anchor
(``DegenerateAnchorError``); any other error propagates.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from actionmesh_tpu_torch.io.mesh import Mesh, load_glb
from actionmesh_tpu_torch.models.stage0 import make_uv_sphere

logger = logging.getLogger(__name__)


class DegenerateAnchorError(RuntimeError):
    """Stage 0 decoded an empty or non-finite anchor isosurface."""


# ---------------------------------------------------------------------------
# Experiment spec: one object pins every shape and seed shared by data
# generation, training and inference.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CascadeSpec:
    """Tiny-but-real cascade configuration of the closed loop (the JAX
    spec's fields, so a ``spec.json`` either package writes loads in the
    other)."""

    # data
    n_frames: int = 16
    window: int = 8
    window_stride: int = 2
    n_lat: int = 24
    n_lon: int = 32
    image_size: int = 192
    surface_samples: int = 1024
    track_points: int = 512  # decoder-training query/track points per scene
    gt_points: int = 20_000  # ActionBench ground-truth points per scene
    # latent space (frozen tiny TripoSG VAE)
    latent_tokens: int = 16
    latent_channels: int = 8
    vae_width: int = 64
    vae_layers: int = 2
    vae_seed: int = 7
    # conditioning (frozen tiny DINOv2)
    dino_hidden: int = 48
    dino_layers: int = 2
    dino_heads: int = 4
    dino_seed: int = 1
    # Stage-I denoiser
    denoiser_width: int = 128
    denoiser_layers: int = 4
    denoiser_heads: int = 4
    # Stage-II decoder
    decoder_width: int = 128
    decoder_layers: int = 4
    decoder_heads: int = 4
    # sampling
    num_inference_steps: int = 16
    guidance_scale: float = 2.0
    # Stage-0 DiT (image -> 3D latent rectified flow)
    stage0_width: int = 128
    stage0_layers: int = 4
    stage0_heads: int = 4
    stage0_steps: int = 16
    stage0_guidance: float = 2.0
    stage0_dense_depth: int = 7
    stage0_hier_depth: int = 8
    # runtime: the JAX package's attention choice (the port always runs its
    # kernels on the card) and the compute dtype of the pipeline
    attn_impl: str = "chunked"
    compute_dtype: str = "float32"

    # -- derived configs ----------------------------------------------------

    @property
    def dtype(self) -> torch.dtype:
        """The pipeline's ``dtype=`` argument (``compute_dtype``)."""
        return getattr(torch, self.compute_dtype)

    def pipeline_updates(self) -> dict:
        """config_updates for ActionMeshPipeline matching this spec. JAX's
        also sets ``attn_impl`` and ``compute_dtype``: the port's config has
        no such keys (the dtype is the pipeline's ``dtype=``, ``self.dtype``)."""
        return {
            "temporal_3D_denoiser.num_tokens_nominal": self.latent_tokens,
            "temporal_3D_denoiser.in_channels": self.latent_channels,
            "temporal_3D_denoiser.width": self.denoiser_width,
            "temporal_3D_denoiser.num_layers": self.denoiser_layers,
            "temporal_3D_denoiser.num_attention_heads": self.denoiser_heads,
            "temporal_3D_denoiser.cross_attention_dim": self.dino_hidden,
            "temporal_3D_denoiser.inflated_layers": list(range(self.denoiser_layers)),
            "temporal_3D_denoiser.temporal_context_size": self.window,
            "temporal_3D_vae.latent_channels": self.latent_channels,
            "temporal_3D_vae.width": self.decoder_width,
            "temporal_3D_vae.num_layers": self.decoder_layers,
            "temporal_3D_vae.num_attention_heads": self.decoder_heads,
            "temporal_3D_vae.temporal_context_size": self.window,
            "sliding_window_denoiser": self.window - 1,
            "sliding_window_autoencoder": self.window - 1,
            "scheduler.num_inference_steps": self.num_inference_steps,
            "cf_guidance.guidance_scales": [self.guidance_scale],
        }

    def denoiser_config(self):
        from actionmesh_tpu_torch.models.denoiser import DenoiserConfig

        return DenoiserConfig(
            num_tokens_nominal=self.latent_tokens,
            temporal_context_size=self.window,
            in_channels=self.latent_channels,
            num_layers=self.denoiser_layers,
            num_attention_heads=self.denoiser_heads,
            width=self.denoiser_width,
            cross_attention_dim=self.dino_hidden,
            inflated_layers=tuple(range(self.denoiser_layers)),
        )

    def autoencoder_config(self):
        from actionmesh_tpu_torch.models.autoencoder import AutoencoderConfig

        return AutoencoderConfig(
            temporal_context_size=self.window,
            latent_channels=self.latent_channels,
            width=self.decoder_width,
            num_layers=self.decoder_layers,
            num_attention_heads=self.decoder_heads,
        )

    def stage0_dit_config(self):
        """Single-shape DiT (``models/triposg/dit.py``: the denoiser at T=1)."""
        from actionmesh_tpu_torch.models.triposg.dit import triposg_dit_config

        return triposg_dit_config(
            num_tokens=self.latent_tokens,
            in_channels=self.latent_channels,
            num_layers=self.stage0_layers,
            width=self.stage0_width,
            num_attention_heads=self.stage0_heads,
            cross_attention_dim=self.dino_hidden,
        )

    def dino_config(self):
        from actionmesh_tpu_torch.models.dinov2 import DinoV2Config

        return DinoV2Config(
            hidden_size=self.dino_hidden,
            num_layers=self.dino_layers,
            num_heads=self.dino_heads,
            patch_size=14,
            image_size=70,
        )

    def vae_config(self):
        from actionmesh_tpu_torch.models.triposg.vae import TripoSGVAEConfig

        return TripoSGVAEConfig(
            latent_channels=self.latent_channels,
            num_tokens=self.latent_tokens,
            encoder_width=self.vae_width,
            encoder_layers=self.vae_layers,
            encoder_heads=4,
            decoder_width=self.vae_width,
            decoder_layers=self.vae_layers,
            decoder_heads=4,
        )

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(dataclasses.asdict(self), indent=2))

    @classmethod
    def load(cls, path: str | Path) -> "CascadeSpec":
        return cls(**json.loads(Path(path).read_text()))


# ---------------------------------------------------------------------------
# Scene family
# ---------------------------------------------------------------------------


def make_scene(seed: int, spec: CascadeSpec) -> list[Mesh]:
    """Deforming ellipsoid scene: per-axis breathing + bend + translation.

    Frame 0 is the anchor (identity deformation). Motion amplitudes are
    seed-dependent; a final bisection shrinks per-frame deviations from the
    anchor so that, under the anchor's own [-1, 1]^3 normalization
    (``preprocessing/mesh.normalize_mesh``, the transform inference
    applies), every frame stays within 3% of the anchor's envelope, keeping
    targets inside the decoder's sigmoid range. The JAX package's numpy
    arithmetic, so the same seed gives the same meshes.
    """
    rng = np.random.default_rng(seed)
    base = make_uv_sphere(radius=1.0, n_lat=spec.n_lat, n_lon=spec.n_lon)
    radii = 0.5 + 0.45 * rng.random(3)
    v0 = base.vertices * radii

    amp = 0.10 + 0.18 * rng.random(3)  # breathing amplitude per axis
    freq = rng.integers(1, 3, 3).astype(np.float64)  # cycles per clip
    phase = rng.random(3) * 2 * np.pi
    bend = 0.5 * rng.standard_normal()
    tdir = rng.normal(size=3)
    tdir /= np.linalg.norm(tdir)
    tamp = 0.05 + 0.08 * rng.random()

    def deform(a: float) -> np.ndarray:
        # shrink-only breathing: s(0) = 1 (the anchor is the largest extent)
        s = 1.0 - amp * (1.0 - np.cos(2 * np.pi * freq * a + 0 * phase)) / 2.0
        v = v0 * s
        ang = bend * a * v[:, 0]
        ca, sa = np.cos(ang), np.sin(ang)
        v = np.stack([v[:, 0], ca * v[:, 1] - sa * v[:, 2], sa * v[:, 1] + ca * v[:, 2]], axis=1)
        return v + tdir * (tamp * np.sin(np.pi * a + phase[0]) ** 2)

    T = spec.n_frames
    frames = [deform(t / (T - 1)) for t in range(T)]

    # the anchor normalization; later frames' deviations shrink (bisection
    # on lambda) until they fit inside the anchor's own envelope, with 3%
    # overshoot allowed (training tracks clip the sliver to [-1, 1])
    lo, hi = frames[0].min(0), frames[0].max(0)
    center = (lo + hi) / 2.0
    factor = 2.0 / max(float(np.max(hi - lo)), 1e-12)
    bound = 1.03 * float(np.abs((frames[0] - center) * factor).max())

    def max_norm(lam: float) -> float:
        worst = 0.0
        for v in frames[1:]:
            shrunk = frames[0] + lam * (v - frames[0])
            worst = max(worst, float(np.abs((shrunk - center) * factor).max()))
        return worst

    lam = 1.0
    if max_norm(1.0) > bound:
        lo_l, hi_l = 0.0, 1.0
        for _ in range(30):
            mid = (lo_l + hi_l) / 2.0
            if max_norm(mid) > bound:
                hi_l = mid
            else:
                lo_l = mid
        lam = lo_l
    out = [Mesh(frames[0].copy(), base.faces.copy())]
    for v in frames[1:]:
        out.append(Mesh(frames[0] + lam * (v - frames[0]), base.faces.copy()))
    return out


def tracked_points(meshes: list[Mesh], n_pts: int, seed: int) -> np.ndarray:
    """(T, n_pts, 6) tracked surface points: frame-0 barycentrics replayed
    on every frame (the ActionBench ground-truth layout)."""
    rng = np.random.default_rng(seed)
    m0 = meshes[0]
    _, areas = m0.face_normals_and_areas()
    cdf = np.cumsum(areas) / areas.sum()
    face_ids = np.searchsorted(cdf, rng.random(n_pts))
    u, v = rng.random(n_pts), rng.random(n_pts)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    w = 1 - u - v
    out = []
    for m in meshes:
        tri = m.vertices[m.faces[face_ids]]
        pts = u[:, None] * tri[:, 0] + v[:, None] * tri[:, 1] + w[:, None] * tri[:, 2]
        nrm, _ = m.face_normals_and_areas()
        out.append(np.concatenate([pts, nrm[face_ids]], axis=1))
    return np.stack(out).astype(np.float32)


def render_frames(meshes: list[Mesh], spec: CascadeSpec) -> list[np.ndarray]:
    """(H, W, 4) uint8 RGBA frames of the (normalized-space) scene from a
    fixed camera (the native rasterizer, shaded)."""
    from actionmesh_tpu_torch.render.cameras import get_uniform_cameras
    from actionmesh_tpu_torch.render.renderer import Renderer

    cam = get_uniform_cameras(n_views=1)[0]
    renderer = Renderer(image_size=spec.image_size, mode="shaded")
    return [renderer.render(m, cam, return_alpha=True) for m in meshes]


def normalized_scene(meshes: list[Mesh]) -> tuple[list[Mesh], np.ndarray, float]:
    """The scene under its anchor's ``normalize_mesh`` transform (what the
    inference pipeline applies), with the transform."""
    from actionmesh_tpu_torch.preprocessing.mesh import normalize_mesh

    _, center, factor = normalize_mesh(meshes[0])
    return [Mesh((m.vertices - center) * factor, m.faces) for m in meshes], center, factor


def scene_seed(build_seed: int, uid: str) -> int:
    """The seed of scene ``uid`` (``scene_NNNN``) in a build from ``build_seed``."""
    return build_seed * 100_003 + int(uid.rsplit("_", 1)[1])


# ---------------------------------------------------------------------------
# Frozen conditioning stack (shared by data generation and inference)
# ---------------------------------------------------------------------------


class MeanEncodeVAE:
    """A TripoSG pipeline whose ``encode_to_latent`` always returns the
    posterior MEAN (seed ignored): the latent the closed loop trains against
    is the one inference conditions on."""

    def __init__(self, inner):
        self._inner = inner

    def encode_to_latent(self, surface, seed=None) -> torch.Tensor:
        del seed
        return self._inner.encode_to_latent(surface, seed=None)


def tiny_stack_dit_config(spec: CascadeSpec):
    """The frozen stack's TripoSG DiT (never sampled; the pipeline object
    needs one)."""
    from actionmesh_tpu_torch.models.denoiser import DenoiserConfig

    return DenoiserConfig(
        num_tokens_nominal=spec.latent_tokens,
        temporal_context_size=1,
        in_channels=spec.latent_channels,
        num_layers=1,
        num_attention_heads=2,
        width=32,
        cross_attention_dim=spec.dino_hidden,
        inflated_layers=(),
    )


def make_conditioning_stack(
    spec: CascadeSpec,
    device: torch.device,
    dino_params=None,
    vae_params=None,
):
    """(image_encoder, vae): frozen, fp32, drawn from the spec's seeds with
    torch generators on ``device`` unless their params are given (the CPU
    tests carry JAX's over)."""
    from actionmesh_tpu_torch.models.image_encoder import ImageEncoder
    from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline

    device = torch.device(device)
    image_encoder = ImageEncoder(
        device=device, dtype=torch.float32, config=spec.dino_config(),
        init_seed=spec.dino_seed, params=dino_params,
    )
    if vae_params is None:
        pipe = TripoSGPipeline.from_random(
            seed=spec.vae_seed, dtype=torch.float32, dit_cfg=tiny_stack_dit_config(spec),
            vae_cfg=spec.vae_config(), image_encoder=image_encoder, device=device,
        )
    else:
        pipe = TripoSGPipeline(
            dit_params=None, vae_params=vae_params, image_encoder=image_encoder,
            dit_cfg=tiny_stack_dit_config(spec), vae_cfg=spec.vae_config(),
            dtype=torch.float32, device=device,
        )
    return image_encoder, MeanEncodeVAE(pipe)


def scene_surfaces(normed: list[Mesh], spec: CascadeSpec, seed: int) -> np.ndarray:
    """(T, N, 6) per-frame surface samples of the normalized scene: the one
    seeded draw that the clip encode, the SDF pools, the re-encode and the
    oracle share."""
    from actionmesh_tpu_torch.preprocessing.mesh import sample_surface

    return np.stack([
        sample_surface(m, n_points=spec.surface_samples, seed=seed + 101 + t, with_normals=True)
        for t, m in enumerate(normed)
    ])


def _encode(vae, surface: np.ndarray) -> np.ndarray:
    return vae.encode_to_latent(surface).float().cpu().numpy().astype(np.float32)


# ---------------------------------------------------------------------------
# Dataset build
# ---------------------------------------------------------------------------


def build_dataset(
    root: str | Path,
    spec: CascadeSpec,
    n_train: int = 48,
    n_eval: int = 8,
    seed: int = 0,
    device: torch.device = torch.device("cuda"),
    stack=None,
) -> dict:
    """Generate scenes, renders, ground truth and training clips/tracks
    under ``root`` (``stack``: the (image_encoder, vae) to condition with,
    else ``make_conditioning_stack``'s).

    Layout:
      root/spec.json                     the CascadeSpec
      root/split.json                    {"train": [...uids], "eval": [...uids]}
      root/frames/{uid}/frame_%02d.png   RGBA video frames (normalized space)
      root/anchor/{uid}.glb              raw anchor mesh (pipeline 3D input)
      root/gt/{uid}/surfaces.npy         (T, gt_points, 6) raw-space tracked GT
      root/tracks/{uid}/surfaces.npy     (T, track_points, 6) normalized tracks
      root/clips_train/{uid}.npz         Stage-I training clips
      root/clips_eval/{uid}.npz          held-out clips (eval loss only)
    """
    from actionmesh_tpu_torch.io.png import write_png
    from actionmesh_tpu_torch.preprocessing.image import ImagePreprocessor
    from actionmesh_tpu_torch.training.data import write_clip

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    spec.save(root / "spec.json")
    image_encoder, vae = stack or make_conditioning_stack(spec, device)
    preproc = ImagePreprocessor()

    uids = {"train": [], "eval": []}
    for i in range(n_train + n_eval):
        split = "train" if i < n_train else "eval"
        uid = f"scene_{i:04d}"
        s_seed = scene_seed(seed, uid)
        meshes = make_scene(s_seed, spec)
        normed, _, _ = normalized_scene(meshes)

        # ground truth (raw space) + decoder tracks (normalized space)
        gt_dir = root / "gt" / uid
        gt_dir.mkdir(parents=True, exist_ok=True)
        np.save(gt_dir / "surfaces.npy", tracked_points(meshes, spec.gt_points, seed=s_seed + 7))
        tr_dir = root / "tracks" / uid
        tr_dir.mkdir(parents=True, exist_ok=True)
        tracks = tracked_points(normed, spec.track_points, seed=s_seed + 11)
        if np.abs(tracks[..., :3]).max() > 1.031:
            raise ValueError(f"{uid}: tracks leave the anchor's envelope")
        tracks[..., :3] = np.clip(tracks[..., :3], -1.0, 1.0)
        np.save(tr_dir / "surfaces.npy", tracks)

        # anchor mesh (raw): the pipeline's 3D input
        (root / "anchor").mkdir(exist_ok=True)
        meshes[0].export(root / "anchor" / f"{uid}.glb")

        # RGBA video frames (rendered in normalized space)
        frames = render_frames(normed, spec)
        f_dir = root / "frames" / uid
        f_dir.mkdir(parents=True, exist_ok=True)
        for t, fr in enumerate(frames):
            write_png(f_dir / f"frame_{t:02d}.png", fr)

        # Stage-I clip: frozen-DINOv2 context of the PREPROCESSED frames and
        # frozen-VAE mean latents of per-frame surfaces, as inference builds them
        pre = preproc.process_images(list(frames))
        context = image_encoder.encode_images(pre).float().cpu().numpy().astype(np.float32)
        latents = _encode(vae, scene_surfaces(normed, spec, s_seed))
        clip_dir = root / ("clips_train" if split == "train" else "clips_eval")
        clip_dir.mkdir(exist_ok=True)
        write_clip(clip_dir / f"{uid}.npz", latents=latents, context=context,
                   framestep=np.arange(spec.n_frames, dtype=np.float32))
        uids[split].append(uid)
        logger.info("built %s (%s): |latents| std %.3f", uid, split, latents.std())

    (root / "split.json").write_text(json.dumps(uids, indent=2))
    return uids


# ---------------------------------------------------------------------------
# Stage-0 training data (SDF ground truth + anchor clips)
# ---------------------------------------------------------------------------


def build_sdf_dataset(
    root: str | Path,
    spec: CascadeSpec,
    uids: list[str],
    build_seed: int = 0,
    n_near: int = 3072,
    n_uniform: int = 1024,
    tsdf_clamp: float = 0.25,
) -> None:
    """Write VAE supervision per scene: root/sdf/{uid}.npz with the anchor's
    surface samples, a near-surface + uniform query pool, and the EXACT
    truncated signed distance (``preprocessing/sdf``) in normalized space."""
    from actionmesh_tpu_torch.preprocessing.mesh import normalize_mesh
    from actionmesh_tpu_torch.preprocessing.sdf import mesh_tsdf, sample_sdf_queries

    out_dir = Path(root) / "sdf"
    out_dir.mkdir(parents=True, exist_ok=True)
    for uid in uids:
        s_seed = scene_seed(build_seed, uid)
        anchor_n, _, _ = normalize_mesh(make_scene(s_seed, spec)[0])
        pool = sample_sdf_queries(anchor_n, n_near, n_uniform, seed=s_seed + 31)
        tsdf = mesh_tsdf(pool, anchor_n, clamp=tsdf_clamp)
        # the anchor frame only, the same seeded draw as the clip encode
        surface = scene_surfaces([anchor_n], spec, s_seed)[0]
        np.savez(out_dir / f"{uid}.npz", surface=surface, points=pool, tsdf=tsdf)
        logger.info("sdf %s: inside frac %.2f, |tsdf| mean %.3f",
                    uid, float((tsdf < 0).mean()), float(np.abs(tsdf).mean()))


def load_sdf_dataset(root: str | Path, uids: list[str]) -> list[dict]:
    """The SDF scene dicts of ``training/vae_train.sdf_batches``."""
    out = []
    for uid in uids:
        with np.load(Path(root) / "sdf" / f"{uid}.npz") as z:
            out.append({k: z[k] for k in ("surface", "points", "tsdf")})
    return out


def reencode_clips(root: str | Path, spec: CascadeSpec, vae, build_seed: int = 0) -> None:
    """Rewrite the latents of clips_train/clips_eval through a (re)trained
    VAE: the Stage-0 phase changes the latent definition, so Stage I/II
    retrain on re-encoded clips. Context and framestep are kept (the frozen
    DINOv2 is unchanged); surfaces regenerate from the scene seeds as
    ``build_dataset`` drew them."""
    from actionmesh_tpu_torch.training.data import write_clip

    root = Path(root)
    split = json.loads((root / "split.json").read_text())
    for split_name, clip_sub in (("train", "clips_train"), ("eval", "clips_eval")):
        for uid in split[split_name]:
            s_seed = scene_seed(build_seed, uid)
            normed, _, _ = normalized_scene(make_scene(s_seed, spec))
            latents = _encode(vae, scene_surfaces(normed, spec, s_seed))
            path = root / clip_sub / f"{uid}.npz"
            with np.load(path) as z:
                context, framestep = z["context"], z["framestep"]
            write_clip(path, latents=latents, context=context, framestep=framestep)
            logger.info("re-encoded %s (%s)", uid, split_name)


def write_stage0_clips(root: str | Path, spec: CascadeSpec, vae, uids: list[str]) -> None:
    """Anchor-only (T=1) clips for the Stage-0 DiT's flow training: the
    latent is the trained VAE's posterior mean of the anchor surface, the
    context the anchor frame's stored DINOv2 features."""
    from actionmesh_tpu_torch.training.data import write_clip

    root = Path(root)
    out_dir = root / "clips_stage0"
    out_dir.mkdir(exist_ok=True)
    for uid in uids:
        with np.load(root / "sdf" / f"{uid}.npz") as z:
            surface = z["surface"]
        clip = root / "clips_train" / f"{uid}.npz"
        if not clip.exists():
            clip = root / "clips_eval" / f"{uid}.npz"
        with np.load(clip) as z:
            context = z["context"][:1]
        write_clip(out_dir / f"{uid}.npz", latents=_encode(vae, surface[None]), context=context,
                   framestep=np.zeros((1,), np.float32))


# ---------------------------------------------------------------------------
# Inference pipeline assembly
# ---------------------------------------------------------------------------


class Stage0Adapter:
    """The image-to-3D backend over a trained TripoSGPipeline, with the
    spec's extraction depths; raises ``DegenerateAnchorError`` when the
    decoded anchor is empty or not finite."""

    def __init__(self, pipeline, dense_depth: int, hier_depth: int):
        self.pipeline = pipeline
        self.dense_depth = dense_depth
        self.hier_depth = hier_depth

    def __call__(self, image, seed=44, num_inference_steps=16, guidance_scale=2.0, **decode_kwargs):
        latent, mesh = self.pipeline(
            image, seed=seed, num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, dense_octree_depth=self.dense_depth,
            hierarchical_octree_depth=self.hier_depth, **decode_kwargs,
        )
        if mesh.n_faces == 0 or not np.isfinite(mesh.vertices).all():
            raise DegenerateAnchorError(
                f"Stage 0 decoded a degenerate anchor ({mesh.n_vertices} vertices, "
                f"{mesh.n_faces} faces)"
            )
        return latent, mesh


def make_trained_stage0(spec: CascadeSpec, stage0_dir: str | Path, image_encoder, device):
    """The trained TripoSGPipeline (``dit.npz`` + ``vae.npz`` of the stage0
    phase), fp32."""
    from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline
    from actionmesh_tpu_torch.utils.weights import load_npz

    stage0_dir = Path(stage0_dir)
    return TripoSGPipeline(
        dit_params=load_npz(stage0_dir / "dit.npz", device),
        vae_params=load_npz(stage0_dir / "vae.npz", device),
        image_encoder=image_encoder,
        dit_cfg=spec.stage0_dit_config(),
        vae_cfg=spec.vae_config(),
        dtype=torch.float32,
        device=device,
    )


def make_pipeline(
    spec: CascadeSpec,
    ckpt_dir: Optional[str | Path] = None,
    extra_updates: Optional[dict] = None,
    stage0_dir: Optional[str | Path] = None,
    video_mode: bool = False,
    device: torch.device = torch.device("cuda"),
    stack=None,
):
    """The REAL pipeline at the spec's tiny scale.

    Default: the {video + 3D} pipeline with the frozen conditioning stack
    (``stack``, else ``make_conditioning_stack``'s), Stage I/II random
    (from seed 0) unless ``ckpt_dir`` holds exported checkpoints.
    ``stage0_dir``: the TRAINED Stage-0 stack instead: its VAE becomes the
    encode path (posterior mean) and, with ``video_mode``, the video -> 4D
    ActionMeshPipeline runs with the trained TripoSG pipeline as its
    image-to-3D backend.
    """
    from actionmesh_tpu_torch.models.stage0 import StubImageTo3D
    from actionmesh_tpu_torch.pipeline import ActionMeshPipeline
    from actionmesh_tpu_torch.pipeline_with_3d import ActionMeshPipelineWithMeshInput

    device = torch.device(device)
    updates = spec.pipeline_updates()
    if stage0_dir is not None:
        updates["stage_0.num_inference_steps"] = spec.stage0_steps
        updates["stage_0.guidance_scale"] = spec.stage0_guidance
    if extra_updates:
        updates.update(extra_updates)
    image_encoder, vae = stack or make_conditioning_stack(spec, device)
    if stage0_dir is not None:
        trained = make_trained_stage0(spec, stage0_dir, image_encoder, device)
        vae = MeanEncodeVAE(trained)
        image_to_3d = Stage0Adapter(trained, spec.stage0_dense_depth, spec.stage0_hier_depth)
    else:
        image_to_3d = StubImageTo3D(latent_shape=(spec.latent_tokens, spec.latent_channels), device=device)
    common = dict(
        config_name="actionmesh", weights_dir=None, config_updates=updates, dtype=spec.dtype,
        device=device, image_encoder=image_encoder, image_to_3d=image_to_3d,
    )
    if video_mode:
        pipe = ActionMeshPipeline(**common)
        pipe.vae = vae
    else:
        pipe = ActionMeshPipelineWithMeshInput(surface_samples=spec.surface_samples, vae=vae, **common)
    if ckpt_dir is not None:
        pipe.load_native(ckpt_dir)
    return pipe


def load_video(root: Path, uid: str, spec: CascadeSpec):
    """ActionMeshInput over the scene's saved RGBA frames."""
    from actionmesh_tpu_torch.io.png import read_png
    from actionmesh_tpu_torch.io.video_input import ActionMeshInput

    frames = [read_png(Path(root) / "frames" / uid / f"frame_{t:02d}.png") for t in range(spec.n_frames)]
    return ActionMeshInput(frames=frames, timesteps=np.arange(spec.n_frames, dtype=np.float32))


def _export(meshes: list[Mesh], out_dir: Path) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    for t, m in enumerate(meshes):
        m.export(out_dir / f"mesh_{t:02d}.glb")


def run_inference(root, pipe, uids: list[str], out_dir, spec: CascadeSpec, seed: int = 44) -> None:
    """Drive the {video + 3D} pipeline on each held-out scene; save the
    predicted meshes as ``out_dir/{uid}/mesh_XX.glb``."""
    root, out_dir = Path(root), Path(out_dir)
    for uid in uids:
        video = load_video(root, uid, spec)
        anchor = load_glb(root / "anchor" / f"{uid}.glb")
        meshes = pipe(video, anchor_mesh=anchor, seed=seed)
        _export(meshes, out_dir / uid)
        logger.info("inferred %s: %d meshes", uid, len(meshes))


def run_inference_video(
    root, pipe, uids: list[str], out_dir, spec: CascadeSpec, seed: int = 44
) -> list[str]:
    """Drive the video -> 4D entry on each held-out scene: Stage 0 generates
    the anchor mesh and latent from the anchor frame alone. Outputs live in
    the pipeline's normalized space (ActionBench's rigid + scale ICP absorbs
    the frame difference). A scene whose Stage 0 gives a degenerate anchor
    is skipped (no predictions; the report counts it); any other error
    propagates. Returns the skipped uids."""
    root, out_dir = Path(root), Path(out_dir)
    skipped = []
    for uid in uids:
        video = load_video(root, uid, spec)
        try:
            meshes = pipe(video, seed=seed)
        except DegenerateAnchorError as e:
            logger.warning("video->4D skipped %s: %s", uid, e)
            skipped.append(uid)
            continue
        _export(meshes, out_dir / uid)
        logger.info("video->4D inferred %s: %d meshes, anchor %d verts",
                    uid, len(meshes), len(meshes[0].vertices))
    return skipped


def evaluate_predictions(
    root,
    pred_dir,
    csv_path,
    uids: list[str],
    icp_iters: int = 200,
    n_pts_icp: int = 5_000,
    n_pts_chamfer: int = 20_000,
    device: str = "cuda",
) -> dict:
    """Score the predictions of ``uids`` with the ActionBench harness (the
    port's pandas-free evaluator). A scene without predictions (skipped) is
    counted in ``n_samples`` and not in ``n_success``; a scene the
    evaluator fails on raises."""
    from actionmesh_tpu_torch.actionbench.evaluate_dataset import evaluate_dataset

    pred_dir = Path(pred_dir)
    predicted = [u for u in uids if any((pred_dir / u).glob("mesh_*.glb"))]
    ok = []
    if predicted:
        results = evaluate_dataset(
            gt_root=str(Path(root) / "gt"), pred_root=str(pred_dir), output_csv=str(csv_path),
            device=device, icp_iters=icp_iters, n_pts_icp=n_pts_icp, n_pts_chamfer=n_pts_chamfer,
            recompute=True,
        )
        failed = [(s.uid, s.error_message) for s in results.samples if s.status != "success"]
        if failed:
            raise RuntimeError(f"ActionBench failed on {failed}")
        ok = [s for s in results.samples if s.uid in set(uids)]

    def mean(key):
        return float(np.mean([getattr(s, key) for s in ok])) if ok else float("nan")

    return {"n_samples": len(uids), "n_success": len(ok),
            "cd_3d": mean("cd_3d"), "cd_4d": mean("cd_4d"), "cd_motion": mean("cd_motion")}


@torch.no_grad()
def run_inference_oracle(
    root, pipe, uids: list[str], out_dir, spec: CascadeSpec, build_seed: int = 0, seed: int = 44
) -> None:
    """Stage-II-only ablation: the decoder gets GROUND-TRUTH latents, the
    VAE's mean encode of every frame's true surface (the training clips'
    construction), then the real Stage-II decode, de-normalization and
    re-expansion. (oracle - identity) is what Stage II loses, (trained -
    oracle) what Stage I loses."""
    from actionmesh_tpu_torch.preprocessing.mesh import denormalize_mesh

    root, out_dir = Path(root), Path(out_dir)
    for uid in uids:
        s_seed = scene_seed(build_seed, uid)
        meshes_gt = make_scene(s_seed, spec)
        video = load_video(root, uid, spec)
        anchor = load_glb(root / "anchor" / f"{uid}.glb")
        latent_bank, mesh_bank, (center, factor), vertex_merge_map, pre_merge_faces = (
            pipe.init_banks_from_anchor(video, anchor, seed)
        )
        normed = [Mesh((m.vertices - center) * factor, m.faces) for m in meshes_gt]
        latents = pipe.vae.encode_to_latent(scene_surfaces(normed, spec, s_seed))  # (T, K, C)
        latent_bank.update(timesteps=video.timesteps[1:], latents=latents[1:])
        mesh_bank = pipe.generate_mesh_animation(latent_bank=latent_bank, mesh_bank=mesh_bank)
        out = [denormalize_mesh(m, center, factor) for m in mesh_bank.get_ordered()[0]]
        _export([Mesh(vertices=m.vertices[vertex_merge_map], faces=pre_merge_faces) for m in out],
                out_dir / uid)
        logger.info("oracle-decoded %s: %d meshes", uid, len(out))
