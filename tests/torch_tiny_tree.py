"""A tiny ``pretrained_weights/`` tree of all four families, built once a
test process and shared by the port's checkpoint, ingest and {video + 3D}
tests (``tiny_tree``). Tests read it and never write into it.

ActionMesh comes from a tiny development pipeline's weights, TripoSG (its
VAE's SDF head shaped to a rounded sphere) and DINOv2 from seeded port
inits, RMBG from the JAX suite's 1/8-channel ISNet transcription; fp32
safetensors with the release's names and config.json files.
"""

import dataclasses

import pytest
import torch

from actionmesh_tpu_torch.models.dinov2 import DinoV2Config, init_dinov2
from actionmesh_tpu_torch.models.triposg.dit import init_triposg_dit, triposg_dit_config
from actionmesh_tpu_torch.models.triposg.vae import TripoSGVAEConfig, init_triposg_vae
from actionmesh_tpu_torch.pipeline import ActionMeshPipeline
from synthetic_checkpoints import reference_state_dict, shape_vae_sdf, write_checkpoint
from tests.test_rmbg_parity import RefISNet, _randomize_bn
from tests.test_torch_pipeline import TINY_DINO, TINY_UPDATES

CPU = torch.device("cpu")
# the tiny TripoSG of the tree; the VAE's heads are the default 8
# (config.json does not carry them), head dim 4
TINY_TRIPOSG_DIT = {"_class_name": "TripoSGDiTModel", "_diffusers_version": "0.30.0", "num_tokens": 16,
                    "in_channels": 8, "out_channels": 8, "num_layers": 3, "width": 64,
                    "num_attention_heads": 2, "cross_attention_dim": 32}
TINY_TRIPOSG_VAE = {"_class_name": "TripoSGVAEModel", "latent_channels": 8, "num_tokens": 16,
                    "embed_frequency": 8, "width_encoder": 32, "num_layers_encoder": 2,
                    "width_decoder": 32, "num_layers_decoder": 2}


def write_tiny_tree(root, pipe) -> None:
    """All four families at tiny widths under ``root``: ActionMesh from
    ``pipe``'s (development) weights, the rest from seeded inits."""
    heads = pipe.denoiser_config.num_attention_heads
    write_checkpoint(root / "ActionMesh" / "denoiser",
                     reference_state_dict("denoiser", pipe.denoiser_params, heads),
                     config=dataclasses.asdict(pipe.denoiser_config))
    write_checkpoint(root / "ActionMesh" / "autoencoder",
                     reference_state_dict("autoencoder", pipe.autoencoder_params,
                                          pipe.autoencoder_config.num_attention_heads),
                     config=dataclasses.asdict(pipe.autoencoder_config))
    gen = torch.Generator().manual_seed(7)
    dit_cfg = triposg_dit_config(**{k: v for k, v in TINY_TRIPOSG_DIT.items() if not k.startswith("_")
                                    and k != "out_channels"})
    write_checkpoint(root / "TripoSG" / "transformer",
                     reference_state_dict("triposg_dit", init_triposg_dit(gen, dit_cfg)),
                     config=TINY_TRIPOSG_DIT, shard_bytes=200_000)  # sharded, with its index
    vae_cfg = TripoSGVAEConfig(latent_channels=8, num_tokens=16, encoder_width=32, encoder_layers=2,
                               decoder_width=32, decoder_layers=2)
    write_checkpoint(root / "TripoSG" / "vae",
                     shape_vae_sdf(reference_state_dict("triposg_vae", init_triposg_vae(gen, vae_cfg)), vae_cfg),
                     config=TINY_TRIPOSG_VAE)
    write_checkpoint(root / "dinov2", reference_state_dict("dinov2", init_dinov2(gen, DinoV2Config(**TINY_DINO))),
                     config={"model_type": "dinov2", "hidden_size": 32, "num_hidden_layers": 2,
                             "num_attention_heads": 2, "patch_size": 14, "image_size": 70})
    torch.manual_seed(3)
    isnet = RefISNet(scale_div=8).eval()
    _randomize_bn(isnet, seed=4)
    write_checkpoint(root / "RMBG", dict(isnet.state_dict()))


_BUILT: list = []  # the one tree of this process


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory):
    """(root of the tree, the development pipeline its ActionMesh weights
    came from); built on first use, once a process whichever test module
    asks first (each module that imports the fixture has its own copy of
    it, so the cache is this module's)."""
    if not _BUILT:
        root = tmp_path_factory.mktemp("pretrained_weights")
        dev = ActionMeshPipeline(weights_dir=None, device=CPU, dtype=torch.float32,
                                 config_updates=dict(TINY_UPDATES))
        write_tiny_tree(root, dev)
        _BUILT.append((root, dev))
    return _BUILT[0]
