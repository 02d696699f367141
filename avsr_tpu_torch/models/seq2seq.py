"""Model assembly, eval path (counterpart of ``avsr_tpu/models/seq2seq.py``).

The port covers the ``av_align`` architecture with cross-attention fusion
and the transformer decoder — the ``lrs2_av_fast`` preset's structure:
compact int16/uint8 inputs are dequantized on the device, audio goes
through the log-mel frontend and the pyramidal BiLSTM stack, video through
the lip-ROI CNN and its BiLSTM, the two meet in cross-attention fusion, and
the fused memory is prepared (value-only) for the decoder.

Layouts: frontends batch-major [B, T, D]; the recurrent core time-major
[T, B, D]; decoder memories batch-major [B, S, H].
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from avsr_tpu.configs import ExperimentConfig
from avsr_tpu_torch.models import decoder as dec
from avsr_tpu_torch.models import encoder as enc
from avsr_tpu_torch.models import fusion as fus
from avsr_tpu_torch.models import video_cnn
from avsr_tpu_torch.ops import attention as attn
from avsr_tpu_torch.ops.audio_features import logmel_frontend
from avsr_tpu_torch.utils.numerics import compute_dtype_of
from avsr_tpu_torch.utils.params import Params


class Batch(NamedTuple):
    audio: torch.Tensor          # [B, S] float32 waveform, or int16 PCM
    audio_lengths: torch.Tensor  # [B] samples
    video: torch.Tensor          # [B, T_v, H, W, C] float32, or uint8 pixels
    video_lengths: torch.Tensor  # [B] frames


class EncodeOutput(NamedTuple):
    memories: Tuple[attn.AttentionMemory, ...]
    aux: Dict[str, Any]


def _check_supported(cfg: ExperimentConfig) -> None:
    if cfg.architecture != "av_align" or cfg.fusion.fusion_type != "cross_attention":
        raise ValueError(
            "the port covers architecture='av_align' with cross-attention fusion "
            f"(got {cfg.architecture!r} / {cfg.fusion.fusion_type!r})")


def memory_dims_of(cfg: ExperimentConfig) -> List[int]:
    _check_supported(cfg)
    audio_out = enc.encoder_output_dim(cfg.audio_encoder)
    video_out = enc.encoder_output_dim(cfg.video_encoder)
    return [audio_out + (cfg.fusion.memory_value_dim or video_out)]


def model_init(cfg: ExperimentConfig, vocab_size: int, generator: torch.Generator,
               device="cpu") -> Params:
    """Random parameters with the reference tree's keys, shapes and
    distributions (``avsr_tpu/models/seq2seq.py:model_init``)."""
    _check_supported(cfg)
    g = generator
    params: Params = {
        "audio_encoder": enc.encoder_init(g, cfg.audio_encoder, cfg.audio.output_dim, device),
        "video_frontend": video_cnn.video_cnn_init(g, cfg.video, device),
        "video_encoder": enc.encoder_init(g, cfg.video_encoder, cfg.video.embedding_dim, device),
    }
    params["fusion"] = fus.cross_attention_fusion_init(
        g, cfg.fusion, enc.encoder_output_dim(cfg.audio_encoder),
        enc.encoder_output_dim(cfg.video_encoder), device)
    params["decoder"] = dec.decoder_init(g, cfg.decoder, memory_dims_of(cfg), vocab_size, device)
    return params


def prep(dec_cfg, params: Params, idx: int, memory, lengths, cdt) -> attn.AttentionMemory:
    """The transformer decoder's memories are value-only."""
    return attn.prepare_memory("value_only", params["decoder"]["atts"][idx],
                               memory, lengths, cdt)


def encode(params: Params, cfg: ExperimentConfig, batch: Batch) -> EncodeOutput:
    """Batch -> prepared decoder memories (eval: no noise, no dropout)."""
    _check_supported(cfg)
    cdt = compute_dtype_of(cfg)
    aux: Dict[str, Any] = {}

    wav = batch.audio
    if wav.dtype == torch.int16:
        wav = wav.float() / 32767.0  # compact-transfer PCM
    feats, feat_len = logmel_frontend(wav, batch.audio_lengths, cfg.audio, cdt=cdt)
    aux["audio_frontend_lengths"] = feat_len

    video = batch.video
    if video.dtype == torch.uint8:
        video = video.float() / 255.0  # compact-transfer ROI crops
    v_emb, v_len = video_cnn.video_cnn_apply(
        params["video_frontend"], cfg.video, video, batch.video_lengths, cdt)

    audio_out_tb, _ = enc.encoder_apply(
        params["audio_encoder"], cfg.audio_encoder, feats.transpose(0, 1), feat_len, cdt)
    v_out_tb, _ = enc.encoder_apply(
        params["video_encoder"], cfg.video_encoder, v_emb.transpose(0, 1), v_len, cdt)
    audio_mem_len = enc.encoder_output_lengths(cfg.audio_encoder, feat_len)
    video_mem_len = enc.encoder_output_lengths(cfg.video_encoder, v_len)
    aux["audio_feature_lengths"] = audio_mem_len

    out = fus.cross_attention_fusion_apply(
        params["fusion"], cfg.fusion, audio_out_tb, audio_mem_len,
        v_out_tb.transpose(0, 1), video_mem_len, cdt)
    aux["av_alignments"] = out.alignments
    aux["au_predictions"] = out.au_predictions
    mem = prep(cfg.decoder, params, 0, out.fused.transpose(0, 1), audio_mem_len, cdt)
    return EncodeOutput(memories=(mem,), aux=aux)


def batch_to_device(arrays: Dict[str, Any], device) -> Batch:
    """Host numpy arrays (as a Predictor assembles them) -> device Batch."""
    t = {k: torch.as_tensor(v).to(device) for k, v in arrays.items()}
    return Batch(audio=t["audio"], audio_lengths=t["audio_lengths"],
                 video=t["video"], video_lengths=t["video_lengths"])
