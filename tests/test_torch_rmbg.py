"""The port's RMBG matting and mask refinement against the JAX package's.

A 1/8-channel ISNet (the JAX suite's torch transcription ``RefISNet``, with
non-trivial BatchNorm) goes through both ``convert_rmbg_weights`` (leaves
bit-equal, BN folded) and both forwards, odd sizes included; the BILINEAR
resize is held equal to PIL's; the refinement equal to JAX's; and
``BackgroundRemover.process_images`` on RGB frames gives JAX's alpha, but
for the few pixels whose matte sits on the Otsu threshold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from actionmesh_tpu.models import rmbg as jrmbg
from actionmesh_tpu.preprocessing import background as jbg
from actionmesh_tpu_torch.io.video_input import pil_resize
from actionmesh_tpu_torch.models import rmbg as trmbg
from actionmesh_tpu_torch.preprocessing import background as tbg
from actionmesh_tpu_torch.utils.safetensors import save_file
from actionmesh_tpu_torch.utils.tree import named_leaves
from tests.test_rmbg_parity import RefISNet, _randomize_bn

CPU = torch.device("cpu")
# a 64 x 64 model input keeps the forwards cheap; the production size is 1024
SMALL = dict(input_size=64)


@pytest.fixture(scope="module")
def isnet():
    """(torch transcription, its state dict as numpy, JAX tree, port tree)."""
    torch.manual_seed(3)
    model = RefISNet(scale_div=8).eval()
    _randomize_bn(model, seed=4)
    state = {k: v.detach().numpy() for k, v in model.state_dict().items()
             if "num_batches_tracked" not in k}
    return model, state, jrmbg.convert_rmbg_weights(state), trmbg.convert_rmbg_weights(state)


def test_convert_rmbg_weights_bit_equal(isnet):
    """BN folded in the JAX converter's arithmetic: every leaf bit-equal."""
    _, state, jtree, ttree = isnet
    jl, tl = dict(named_leaves(jtree)), dict(named_leaves(ttree))
    assert jl.keys() == tl.keys()
    n_convs = sum(1 for v in state.values() if v.ndim == 4)
    assert len(tl) == 2 * n_convs
    for name in jl:
        assert tl[name].dtype == torch.float32
        np.testing.assert_array_equal(tl[name].numpy(), np.asarray(jl[name]), err_msg=name)
    assert tl["stage1.rebnconvin.kernel"].shape == (3, 3, 8, 8)  # HWIO, as JAX


@pytest.mark.parametrize("hw", [(64, 64), (45, 45), (37, 50)])
def test_forward_matches_jax_and_transcription(isnet, hw):
    """Odd sizes exercise max pooling's ceil mode ("SAME", -inf padding)
    and the upsampling to odd targets. Tolerance 2e-4 on logits of
    magnitude ~1, as the JAX suite's parity test (fp32, sums in another
    order; TF32 is off)."""
    model, _, jtree, ttree = isnet
    x = np.random.default_rng(5).uniform(-0.5, 0.5, size=(2,) + hw + (3,)).astype(np.float32)
    with torch.no_grad():
        ref = model(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        out = trmbg.rmbg_forward(trmbg.conv_weights(ttree), torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    jout = np.asarray(jrmbg.rmbg_forward(jtree, jnp.asarray(x))).transpose(0, 3, 1, 2)
    assert out.shape == ref.shape == jout.shape == (2, 1) + hw
    np.testing.assert_allclose(out, ref, atol=2e-4)
    np.testing.assert_allclose(out, jout, atol=2e-4)


@pytest.mark.parametrize("src,dst", [((37, 53), (64, 64)), ((64, 64), (37, 53)), ((480, 270), (1024, 1024)),
                                     ((1024, 1024), (301, 199)), ((33, 33), (33, 47))])
@pytest.mark.parametrize("channels", [3, None])
def test_bilinear_resize_equals_pil(src, dst, channels):
    """PIL's BILINEAR in its fixed-point arithmetic, RGB and L, down
    (support widened by the scale) and up: every pixel equal."""
    h, w = src
    shape = (h, w, channels) if channels else (h, w)
    img = np.random.default_rng(h * w).integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BILINEAR))
    np.testing.assert_array_equal(pil_resize(img, (dst[1], dst[0]), "bilinear"), ref)


def test_refinement_equals_jax():
    rng = np.random.default_rng(6)
    mattes = [rng.integers(0, 256, (40, 50), dtype=np.uint8),
              np.clip(rng.normal(128, 60, (64, 64)), 0, 255).astype(np.uint8),
              np.full((16, 16), 7, np.uint8)]
    blobs = np.zeros((60, 60), np.uint8)
    blobs[5:30, 5:30] = 200
    blobs[40:42, 40:42] = 220  # a 4-pixel component
    blobs[50, 10] = 255
    mattes.append(blobs)
    for m in mattes:
        assert tbg.otsu_threshold(m) == jbg.otsu_threshold(m)
        binary = m > 100
        for min_size in (0, 3, 5, 400):
            np.testing.assert_array_equal(tbg.remove_small_components(binary, min_size),
                                          jbg.remove_small_components(binary, min_size))
        np.testing.assert_array_equal(tbg.refine_mask(m), jbg.refine_mask(m))
    refined = tbg.refine_mask(blobs, min_size_ratio=0.002)
    assert refined[10, 10] == 255 and refined[41, 41] == 0 and refined[50, 10] == 0


def rgb_frames(n=3, size=(72, 96)):
    """A bright textured square on a darker noisy background, no alpha."""
    rng = np.random.default_rng(8)
    frames = []
    for i in range(n):
        img = rng.integers(0, 60, size + (3,), dtype=np.uint8)
        img[16:56, 20 + 4 * i : 60 + 4 * i] = rng.integers(150, 255, (40, 40, 3), dtype=np.uint8)
        frames.append(img)
    return frames


def test_process_images_matches_jax(isnet):
    """RGB frames are matted (RMBG at a 64 x 64 input) and refined; the
    mattes agree within one level (uint8 truncation of fp32 values that
    differ by float rounding), the refined alphas in all but at most 0.5% of
    the pixels, those whose matte sits on the Otsu threshold."""
    _, _, jtree, ttree = isnet
    jrm = jbg.BackgroundRemover(weights_dir=None)
    jrm._model = jrmbg.RMBGModel(jtree, jrmbg.RMBGConfig(**SMALL))
    trm = tbg.BackgroundRemover(None, CPU)
    trm._model = trmbg.RMBGModel(ttree, CPU, trmbg.RMBGConfig(**SMALL), batch_size=2)
    frames = rgb_frames()
    jout = jrm.process_images([Image.fromarray(f) for f in frames])
    tout = trm.process_images(frames)
    for f, j, t in zip(frames, jout, tout):
        j = np.asarray(j)
        assert t.shape == j.shape == f.shape[:2] + (4,)
        np.testing.assert_array_equal(t[..., :3], f)
        differ = int((t[..., 3] != j[..., 3]).sum())
        assert differ <= 0.005 * f.shape[0] * f.shape[1], differ
        assert 0 < (t[..., 3] > 0).mean() < 1
    for f in frames:
        jm = jrm._model.predict_alpha(Image.fromarray(f))
        tm = trm._model.predict_alpha(f)
        assert tm.shape == jm.shape == f.shape[:2]
        assert np.abs(tm.astype(int) - jm).max() <= 1


def test_valid_alpha_skips_matting_and_missing_weights_raise(tmp_path):
    rgba = np.zeros((32, 32, 4), np.uint8)
    rgba[8:24, 8:24] = 255
    frames = [rgba] * 3
    remover = tbg.BackgroundRemover(tmp_path / "absent", CPU)
    assert remover.process_images(frames) is frames
    with pytest.raises(RuntimeError, match="RMBG-1.4 weights"):
        remover.process_images([rgba[..., :3]] + frames[1:])
    # full alpha carries no matte either: it is matted
    with pytest.raises(RuntimeError, match="RMBG-1.4 weights"):
        remover.process_images([np.full((32, 32, 4), 255, np.uint8)])


def test_from_pretrained_reads_the_checkpoint(isnet, tmp_path):
    model, _, jtree, _ = isnet
    save_file(dict(model.state_dict()), tmp_path / "model.safetensors")
    loaded = trmbg.RMBGModel.from_pretrained(tmp_path, CPU)
    w = loaded.params["stage3"]["rebnconv2d"]["weight"]
    np.testing.assert_array_equal(w.numpy(), np.asarray(jtree["stage3"]["rebnconv2d"]["kernel"]).transpose(3, 2, 0, 1))
    assert loaded.cfg.input_size == 1024
