"""The port's loaders, export and preview rendering against the JAX package.

Loaders: the same directories of PNG files through both packages' loaders
(the JAX package decodes with PIL; the port with ``io/png.py``). Export: the
same meshes through both packages' writers, compared byte for byte. Render:
the same mesh and cameras through both renderers (both on the repository's
native z-buffer rasterizer). The GIF fallback is decoded by PIL.
"""

import numpy as np
import pytest
from PIL import Image

from actionmesh_tpu.io import animated_glb as janim
from actionmesh_tpu.io import glb_export as jexport
from actionmesh_tpu.io import mesh_io as jmesh_io
from actionmesh_tpu.io import video_input as jvideo
from actionmesh_tpu.io.mesh import Mesh as JMesh
from actionmesh_tpu.render import cameras as jcams
from actionmesh_tpu.render.renderer import Renderer as JRenderer
from actionmesh_tpu_torch.io import animated_glb as tanim
from actionmesh_tpu_torch.io import glb_export as texport
from actionmesh_tpu_torch.io import mesh_io as tmesh_io
from actionmesh_tpu_torch.io import video_input as tvideo
from actionmesh_tpu_torch.io.mesh import Mesh as TMesh
from actionmesh_tpu_torch.models.stage0 import make_uv_sphere
from actionmesh_tpu_torch.render import cameras as tcams
from actionmesh_tpu_torch.render import utils as rutils
from actionmesh_tpu_torch.render.renderer import Renderer as TRenderer


def frame_rgba(i: int, h=48, w=40) -> np.ndarray:
    rng = np.random.default_rng(i)
    img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    img[..., 3] = 0
    img[10:30, 5 + i % 10 : 25 + i % 10, 3] = 255
    return img


def jax_frames(inp) -> list[np.ndarray]:
    return [np.asarray(f.convert("RGBA")) for f in inp.frames]


def assert_same_input(tin, jin, atol=0):
    assert len(tin.frames) == len(jin.frames)
    np.testing.assert_array_equal(tin.timesteps, jin.timesteps)
    for t, j in zip(tin.frames, jax_frames(jin)):
        assert t.shape == j.shape and t.dtype == np.uint8
        assert np.abs(t.astype(int) - j.astype(int)).max() <= atol


@pytest.fixture(scope="module")
def pair_dir(tmp_path_factory):
    """40 image + mask pairs; every third mask is RGB, every fifth another size."""
    d = tmp_path_factory.mktemp("pairs")
    for i in range(40):
        rgba = frame_rgba(i)
        Image.fromarray(rgba[..., :3]).save(d / f"{i:03d}_image.png")
        mask = Image.fromarray(rgba[..., 3])
        if i % 5 == 0:
            mask = mask.resize((29, 31), Image.BILINEAR)
        if i % 3 == 0:
            mask = mask.convert("RGB")
        mask.save(d / f"{i:03d}_mask.png")
    return d


@pytest.mark.parametrize("stride,max_frames", [(1, None), (2, None), (1, 17), (2, 16)])
def test_image_mask_pairs_match_jax(pair_dir, stride, max_frames):
    """The resized masks (PIL LANCZOS in JAX, its fixed-point port here) are
    held within 1 level; everything else is equal."""
    tin = tvideo.load_from_image_mask_pairs(pair_dir, max_frames=max_frames, stride=stride)
    jin = jvideo.load_from_image_mask_pairs(pair_dir, max_frames=max_frames, stride=stride)
    assert_same_input(tin, jin, atol=1)
    assert_same_input(tvideo.load_frames(pair_dir, max_frames=max_frames, stride=stride),
                      jvideo.load_frames(pair_dir, max_frames=max_frames, stride=stride), atol=1)


def test_lanczos_resize_matches_pil():
    rng = np.random.default_rng(5)
    for (h, w), (H, W) in [((31, 29), (48, 40)), ((200, 120), (64, 90)), ((16, 16), (16, 48))]:
        img = rng.integers(0, 256, (h, w), dtype=np.uint8)
        want = np.asarray(Image.fromarray(img).resize((W, H), Image.LANCZOS))
        got = tvideo.lanczos_resize(img, (W, H))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def glob_dir(tmp_path_factory):
    """Numbered RGBA frames whose natural order is not their sorted order,
    beside a file the glob must not pick up."""
    d = tmp_path_factory.mktemp("frames")
    for i in range(34):
        Image.fromarray(frame_rgba(i)).save(d / f"frame_{i}.png")
    np.save(d / "surfaces.npy", np.zeros(3))
    return d


@pytest.mark.parametrize("stride,max_frames", [(1, None), (2, None), (1, 18)])
def test_image_dir_matches_jax(glob_dir, stride, max_frames):
    pattern = glob_dir / "frame_*.png"
    assert_same_input(tvideo.load_from_image_dir(pattern, max_frames=max_frames, stride=stride),
                      jvideo.load_from_image_dir(pattern, max_frames=max_frames, stride=stride))
    assert_same_input(tvideo.load_frames(glob_dir, max_frames=max_frames, stride=stride),
                      jvideo.load_frames(glob_dir, max_frames=max_frames, stride=stride))


def test_rgb_frames_get_opaque_alpha(tmp_path):
    for i in range(16):
        Image.fromarray(frame_rgba(i)[..., :3]).save(tmp_path / f"{i}.png")
    tin = tvideo.load_frames(tmp_path)
    assert_same_input(tin, jvideo.load_frames(tmp_path))
    assert all((f[..., 3] == 255).all() for f in tin.frames)


def test_missing_decoders_raise(tmp_path):
    """JPEG frames decode (PIL, lazily imported) as JAX's do; a missing video
    file, an empty glob and too few frames raise as in JAX."""
    for i in range(16):
        Image.fromarray(frame_rgba(i)[..., :3]).save(tmp_path / f"{i}.jpg")
    assert_same_input(tvideo.load_frames(tmp_path), jvideo.load_frames(tmp_path))
    with pytest.raises(FileNotFoundError, match="Video file not found"):
        tvideo.load_frames(tmp_path / "clip.mp4")
    with pytest.raises(ValueError, match="No images"):
        tvideo.load_frames(tmp_path / "none_*.png")
    for i in range(3):
        Image.fromarray(frame_rgba(i)).save(tmp_path / f"{i}.png")
    with pytest.raises(ValueError, match="At least 16"):
        tvideo.load_frames(tmp_path / "*.png")


def sequence(n=5, seed=0):
    base = make_uv_sphere(n_lat=10, n_lon=16)
    rng = np.random.default_rng(seed)
    verts = [base.vertices + 0.02 * t * rng.standard_normal(base.vertices.shape) for t in range(n)]
    return ([TMesh(v, base.faces) for v in verts], [JMesh(v, base.faces) for v in verts])


def test_save_meshes_and_deformation_match_jax_bytes(tmp_path):
    tms, jms = sequence()
    tmesh_io.save_meshes(tms, tmp_path / "t")
    jmesh_io.save_meshes(jms, str(tmp_path / "j"))
    for i in range(len(tms)):
        name = f"mesh_{i:02d}.glb"
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    tv, tf = tmesh_io.save_deformation(tms, tmp_path / "t" / "deformations")
    jv, jf = jmesh_io.save_deformation(jms, tmp_path / "j" / "deformations")
    assert tv.read_bytes() == jv.read_bytes() and tf.read_bytes() == jf.read_bytes()
    v = np.load(tv)
    np.testing.assert_array_equal(v[1], np.stack([-tms[1].vertices[:, 2], tms[1].vertices[:, 0],
                                                  tms[1].vertices[:, 1]], -1).astype(np.float32))
    tanim.create_animated_glb_native(np.load(tv), np.load(tf), tmp_path / "t.glb", fps=8)
    janim.create_animated_glb_native(np.load(jv), np.load(jf), tmp_path / "j.glb", fps=8)
    assert (tmp_path / "t.glb").read_bytes() == (tmp_path / "j.glb").read_bytes()


def test_save_deformation_checks_topology(tmp_path):
    tms, _ = sequence(3)
    tms[2] = TMesh(tms[2].vertices, tms[2].faces[::-1])
    with pytest.raises(ValueError, match="face topology"):
        tmesh_io.save_deformation(tms, tmp_path / "d")
    tms[2] = TMesh(tms[1].vertices[:-1], tms[1].faces[:-4])
    with pytest.raises(ValueError, match="vertices"):
        tmesh_io.save_deformation(tms, tmp_path / "d")
    with pytest.raises(ValueError, match="empty"):
        tmesh_io.save_deformation([], tmp_path / "d")


def test_blender_command_line_matches_jax(monkeypatch, tmp_path):
    calls = []

    class Done:
        returncode = 0

    def fake_run(cmd, **kwargs):
        calls.append((cmd, kwargs))
        return Done()

    monkeypatch.setattr(texport.subprocess, "run", fake_run)
    monkeypatch.setattr(jexport.subprocess, "run", fake_run)
    args = dict(vertices_npy="v.npy", faces_npy="f.npy", output_glb="out.glb",
                blender_path="tools/blender/blender", fps=8, export_normals=True,
                input_glb=str(tmp_path / "in.glb"))
    assert texport.create_animated_glb(**args) == jexport.create_animated_glb(**args) == 0
    (tcmd, tkw), (jcmd, jkw) = calls
    assert tcmd[3] == texport.__file__ and jcmd[3] == jexport.__file__
    assert tcmd[:3] + tcmd[4:] == jcmd[:3] + jcmd[4:] and tkw == jkw


def test_cameras_match_jax():
    for n in (1, 3, 5):
        for t, j in zip(tcams.get_uniform_cameras(n), jcams.get_uniform_cameras(n)):
            for key in ("R", "t", "location"):
                np.testing.assert_array_equal(t[key], j[key])
            assert t["focal"] == j["focal"]


@pytest.mark.parametrize("mode", ["normal", "shaded"])
def test_renderer_matches_jax(mode):
    tms, jms = sequence(2, seed=4)
    cams = tcams.get_uniform_cameras(3)
    for return_alpha in (False, True):
        for cam in cams:
            t = TRenderer(image_size=64, mode=mode).render(tms[1], cam, return_alpha=return_alpha)
            j = JRenderer(image_size=64, mode=mode).render(jms[1], cam, return_alpha=return_alpha)
            assert t.shape == j.shape == (64, 64, 4 if return_alpha else 3)
            assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
            assert (t != 255).any()


def test_gif_fallback_decodes_within_the_palette_error(monkeypatch, tmp_path):
    """Without imageio-ffmpeg the preview is a GIF; PIL decodes every frame
    within 25 levels (half the palette's spacing) of what was written."""
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (40, 70, 3), dtype=np.uint8) for _ in range(6)]
    frames[1][:] = 255
    real = rutils.importlib.util.find_spec
    monkeypatch.setattr(rutils.importlib.util, "find_spec",
                        lambda name: None if name == "imageio_ffmpeg" else real(name))
    path = rutils.write_mp4(frames, tmp_path / "grid_normal.mp4", fps=8)
    assert path == tmp_path / "grid_normal.gif"
    gif = Image.open(path)
    assert gif.n_frames == len(frames) and gif.info["duration"] == 120 and gif.info["loop"] == 0
    for i, frame in enumerate(frames):
        gif.seek(i)
        got = np.asarray(gif.convert("RGB")).astype(int)
        assert np.abs(got - frame).max() <= 25
    gif.seek(1)
    assert (np.asarray(gif.convert("RGB")) == 255).all()


def test_render_utils_match_jax():
    from actionmesh_tpu.render import utils as jutils

    items = list(range(7))
    for n in (3, 7, 16):
        assert rutils.resample_list(items, n) == jutils.resample_list(items, n)
    rgba = frame_rgba(3)
    np.testing.assert_array_equal(rutils.composite_rgba_on_white(rgba),
                                  jutils.composite_rgba_on_white(Image.fromarray(rgba)))
    imgs = [frame_rgba(i)[..., :3] for i in range(5)]
    np.testing.assert_array_equal(rutils.make_grid(imgs, 3), jutils.make_grid(imgs, 3))


def test_hf_dryrun_layout_loader_and_evaluator(tmp_path):
    """The HF-layout clone: the loader reads each sample directory's 16
    rgba frames and skips surfaces.npy; the tiny pipeline's CLI path writes
    16 meshes a sample; the evaluator's command line scores the identity
    floor; the report lands under --out only."""
    import torch

    from actionmesh_tpu_torch.actionbench import hf_dryrun
    from actionmesh_tpu_torch.models.dinov2 import DinoV2Config
    from actionmesh_tpu_torch.models.image_encoder import ImageEncoder
    from actionmesh_tpu_torch.pipeline import ActionMeshPipeline
    from tests.test_torch_pipeline import TINY_DINO, TINY_UPDATES

    report = hf_dryrun.main(["--out", str(tmp_path), "--n", "1", "--pred", "gt", "--device", "cpu",
                             "--n_pts_icp", "64", "--n_pts_chamfer", "500"])
    assert report["summary"]["n_success"] == 1 and (tmp_path / "report.json").is_file()
    sample = tmp_path / "actionbench" / "data" / "objaverse_0000000"
    assert sorted(p.name for p in sample.iterdir())[-1] == "surfaces.npy"
    video = tvideo.load_frames(sample)
    assert video.n_frames == 16 and all((f[..., 3] > 0).any() for f in video.frames)

    pipe = ActionMeshPipeline(device=torch.device("cpu"), dtype=torch.float32, weights_dir=None,
                              config_updates=dict(TINY_UPDATES))
    pipe.image_encoder = ImageEncoder(torch.device("cpu"), torch.float32, DinoV2Config(**TINY_DINO))
    pipe.image_to_3d = lambda image, **_: (torch.zeros((1, 16, 8)), make_uv_sphere(n_lat=8, n_lon=16))
    pred_root = hf_dryrun.predict_pipeline(tmp_path, ["objaverse_0000000"], 0, pipe)
    assert len(list((pred_root / "objaverse_0000000").glob("mesh_*.glb"))) == 16
