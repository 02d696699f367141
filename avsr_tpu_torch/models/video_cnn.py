"""Lip-ROI CNN (counterpart of ``avsr_tpu/models/video_cnn.py``).

Frames are folded into the batch ([B, T, H, W, C] -> [B*T, C, H, W]), each
conv runs in the compute dtype with the bias add and ReLU in fp32, and the
flattened NHWC activations are projected to the embedding.  XLA's ``SAME``
padding with stride 2 is asymmetric (36 -> 18 -> 9 -> 5 pads (0,1),
(0,1), (1,1)), so each layer pads explicitly; ``Conv2d(padding=1)`` would
shift the output by one pixel.  Conv kernels are stored ``OIHW``
(``convert.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from avsr_tpu.configs import VideoFrontendConfig
from avsr_tpu_torch.utils.numerics import dot_f32
from avsr_tpu_torch.utils.params import Params, glorot_uniform, zeros


def video_cnn_init(gen: torch.Generator, cfg: VideoFrontendConfig, device="cpu") -> Params:
    if cfg.use_au_features:
        raise ValueError("the port runs the CNN video frontend only (no AU features)")
    params: Params = {"convs": []}
    c_in = cfg.channels
    h, w = cfg.roi_height, cfg.roi_width
    k = cfg.conv_kernel
    for c_out in cfg.conv_channels:
        hwio = glorot_uniform(gen, (k * k * c_in, c_out)).reshape(k, k, c_in, c_out)
        params["convs"].append({
            "w": hwio.permute(3, 2, 0, 1).contiguous().to(device),
            "b": zeros((c_out,), device),
        })
        c_in = c_out
        h = -(-h // cfg.conv_stride)
        w = -(-w // cfg.conv_stride)
    params["proj_w"] = glorot_uniform(gen, (h * w * c_in, cfg.embedding_dim), device)
    params["proj_b"] = zeros((cfg.embedding_dim,), device)
    return params


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA ``SAME`` (low, high) padding of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def video_cnn_apply(params: Params, cfg: VideoFrontendConfig, frames: torch.Tensor,
                    lengths: torch.Tensor, cdt: torch.dtype):
    """[B, T, H, W, C] lip crops -> ([B, T, E] fp32 embeddings, lengths)."""
    B, T = frames.shape[:2]
    mask = (torch.arange(T, device=frames.device)[None, :] < lengths[:, None]).float()
    x = frames.reshape(B * T, *frames.shape[2:]).permute(0, 3, 1, 2).to(cdt)
    for conv in params["convs"]:
        kh = conv["w"].shape[-1]
        ph = same_pads(x.shape[2], kh, cfg.conv_stride)
        pw = same_pads(x.shape[3], kh, cfg.conv_stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        x = F.conv2d(x, conv["w"].to(cdt), stride=cfg.conv_stride)
        x = torch.relu(x.float() + conv["b"][None, :, None, None]).to(cdt)
    x = x.permute(0, 2, 3, 1).reshape(B * T, -1)  # flatten in NHWC order
    emb = dot_f32(x, params["proj_w"], cdt) + params["proj_b"]
    return emb.reshape(B, T, -1) * mask[:, :, None], lengths
