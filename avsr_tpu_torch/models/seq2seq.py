"""Model assembly and the loss (counterpart of ``avsr_tpu/models/seq2seq.py``).

The port covers the ``av_align`` architecture with cross-attention fusion
and the transformer decoder — the ``lrs2_av_fast`` preset's structure:
compact int16/uint8 inputs are dequantized on the device, in training the
waveform is mixed with noise, audio goes through the log-mel frontend and
the pyramidal BiLSTM stack, video through the lip-ROI CNN and its BiLSTM,
the two meet in cross-attention fusion, and the fused memory is prepared
(value-only) for the decoder.  ``loss_fn`` adds the teacher-forced
decoder, the cross-entropy and the AU regression loss.

Randomness (noise draws, dropout masks) comes from ONE generator per
call, drawn in a fixed order: noise, the audio encoder's layers, the video
encoder's, then the decoder's.  SpecAugment, eval-time fixed-SNR mixing
and ``train.remat`` are not ported and raise.

Layouts: frontends batch-major [B, T, D]; the recurrent core time-major
[T, B, D]; decoder memories batch-major [B, S, H].
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from avsr_tpu.configs import ExperimentConfig
from avsr_tpu_torch.models import decoder as dec
from avsr_tpu_torch.models import encoder as enc
from avsr_tpu_torch.models import fusion as fus
from avsr_tpu_torch.models import video_cnn
from avsr_tpu_torch.ops import attention as attn
from avsr_tpu_torch.ops import noise as noise_ops
from avsr_tpu_torch.ops.audio_features import logmel_frontend
from avsr_tpu_torch.utils.numerics import compute_dtype_of
from avsr_tpu_torch.utils.params import Params


class Batch(NamedTuple):
    audio: torch.Tensor          # [B, S] float32 waveform, or int16 PCM
    audio_lengths: torch.Tensor  # [B] samples
    video: torch.Tensor          # [B, T_v, H, W, C] float32, or uint8 pixels
    video_lengths: torch.Tensor  # [B] frames
    targets: Optional[torch.Tensor] = None         # [B, K] unit ids incl. EOS
    target_lengths: Optional[torch.Tensor] = None  # [B] incl. EOS
    au_targets: Optional[torch.Tensor] = None      # [B, T_a, au_dim], frontend rate
    au_row_weights: Optional[torch.Tensor] = None  # [B] 1.0 = row feeds the AU loss
    uid_hashes: Optional[torch.Tensor] = None      # [B] crc32(uid): eval noise keys


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


def encode(params: Params, cfg: ExperimentConfig, batch: Batch, *, train: bool = False,
           generator: Optional[torch.Generator] = None,
           noise_bank=None) -> EncodeOutput:
    """Batch -> prepared decoder memories.  ``train`` mixes noise (when
    ``cfg.noise.enabled`` and a bank is given) and applies the encoders'
    dropout, both drawn from ``generator``."""
    _check_supported(cfg)
    if train and cfg.train.remat:
        raise ValueError("train.remat is not ported")
    if train and cfg.audio.spec_augment:
        raise ValueError("SpecAugment is not ported")
    cdt = compute_dtype_of(cfg)
    aux: Dict[str, Any] = {}

    wav = batch.audio
    if wav.dtype == torch.int16:
        wav = wav.float() / 32767.0  # compact-transfer PCM
    if noise_bank is not None:
        if train and cfg.noise.enabled:
            wav = noise_ops.sample_and_mix(generator, wav, batch.audio_lengths, noise_bank,
                                           cfg.noise.snr_db, cfg.noise.clean_probability)
        elif not train and cfg.noise.eval_snr_db is not None:
            raise ValueError("fixed-SNR eval mixing (mix_fixed_snr) is not ported")
    feats, feat_len = logmel_frontend(wav, batch.audio_lengths, cfg.audio, cdt=cdt)
    aux["audio_frontend_lengths"] = feat_len

    video = batch.video
    if video.dtype == torch.uint8:
        video = video.float() / 255.0  # compact-transfer ROI crops
    v_emb, v_len = video_cnn.video_cnn_apply(
        params["video_frontend"], cfg.video, video, batch.video_lengths, cdt)

    audio_out_tb, _ = enc.encoder_apply(
        params["audio_encoder"], cfg.audio_encoder, feats.transpose(0, 1), feat_len, cdt,
        train=train, generator=generator)
    v_out_tb, _ = enc.encoder_apply(
        params["video_encoder"], cfg.video_encoder, v_emb.transpose(0, 1), v_len, cdt,
        train=train, generator=generator)
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


def forward(params: Params, cfg: ExperimentConfig, batch: Batch, *, train: bool = False,
            generator: Optional[torch.Generator] = None,
            noise_bank=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Teacher-forced logits for the batch: [B, K, V] fp32, and encode's aux."""
    out = encode(params, cfg, batch, train=train, generator=generator, noise_bank=noise_bank)
    logits = dec.teacher_forced_logits(
        params["decoder"], cfg.decoder, batch.targets, batch.target_lengths, out.memories,
        compute_dtype_of(cfg), generator=generator, dropout=train)
    return logits, out.aux


def loss_fn(params: Params, cfg: ExperimentConfig, batch: Batch, *, train: bool = True,
            generator: Optional[torch.Generator] = None,
            noise_bank=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(total loss, {"ce_loss", "au_loss" (when the AU head and targets
    are present), "loss"})."""
    logits, aux = forward(params, cfg, batch, train=train, generator=generator,
                          noise_bank=noise_bank)
    return _losses(cfg, batch, logits, aux, train=train)


def _pool_time(x_tbd: torch.Tensor, lengths: torch.Tensor, r: int) -> torch.Tensor:
    """Masked mean over groups of ``r`` consecutive time-major frames:
    [T, B, D] -> [ceil(T/r), B, D]; frames beyond each example's length
    are left out of their group's denominator."""
    T, B, D = x_tbd.shape
    Tp = -(-T // r) * r
    if Tp != T:
        x_tbd = torch.nn.functional.pad(x_tbd, (0, 0, 0, 0, 0, Tp - T))
    valid = (torch.arange(Tp, device=x_tbd.device)[:, None] < lengths[None, :]).to(x_tbd.dtype)
    groups = x_tbd.reshape(Tp // r, r, B, D)
    v = valid.reshape(Tp // r, r, B, 1)
    return (groups * v).sum(dim=1) / torch.clamp(v.sum(dim=1), min=1.0)


def _losses(cfg: ExperimentConfig, batch: Batch, logits: torch.Tensor, aux: Dict[str, Any], *,
            train: bool) -> Tuple[torch.Tensor, Dict[str, Any]]:
    ce = dec.sequence_loss(logits, batch.targets, batch.target_lengths,
                           label_smoothing=cfg.train.label_smoothing if train else 0.0)
    metrics: Dict[str, Any] = {"ce_loss": ce}
    total = ce
    if (cfg.fusion.au_loss_weight > 0.0 and aux.get("au_predictions") is not None
            and batch.au_targets is not None):
        au_t = batch.au_targets.transpose(0, 1)  # time-major
        R = enc.total_time_reduction(cfg.audio_encoder)
        if R > 1:
            # predictions run at the encoder-output rate; pool the
            # frontend-rate targets to match
            au_t = _pool_time(au_t, aux["audio_frontend_lengths"], R)
        au_loss = fus.au_regression_loss(aux["au_predictions"], au_t,
                                         aux["audio_feature_lengths"],
                                         row_weights=batch.au_row_weights)
        metrics["au_loss"] = au_loss
        total = total + cfg.fusion.au_loss_weight * au_loss
    metrics["loss"] = total
    return total, metrics


def batch_to_device(arrays: Dict[str, Any], device) -> Batch:
    """Host numpy arrays (as a Predictor or a loader assembles them) ->
    device Batch; the fields absent from ``arrays`` stay None."""
    t = {k: torch.as_tensor(v).to(device) for k, v in arrays.items()}
    return Batch(**{k: t.get(k) for k in Batch._fields})
