"""Offline media ingestion: raw audio/video -> Utterances -> TFRecords.

Rebuild of the reference's L0 preprocessing + dataset-writing path
(upstream:avsr/dataset_writer.py and companion ROI tooling, SURVEY.md §2.2
rows 11/15, §3.3): load waveforms, resample, extract lip-ROI crops from
video (face detection + mouth-region crop), import precomputed OpenFace
action-unit CSVs, and serialize per-utterance SequenceExamples.

Everything here is OFFLINE tooling — it never runs in the training path.
Imports of cv2 are gated so environments without media libraries can still
train from prepared records: the two functions that decode video
(``extract_lip_rois``, ``extract_lip_rois_from_landmarks``) import it when
called and raise ImportError where it is missing.  A copy of
``avsr_tpu/data/ingest.py``: the same records from the same media.

Lip-ROI quality ladder (best available wins; SURVEY §2.2 row 15):

  1. **External landmarks** (dlib/OpenFace, the reference's tooling):
     ``rois_from_landmarks`` / ``load_openface_landmarks`` crop around the
     mouth landmark hull (points 48-67) — full parity with the reference
     when an OpenFace CSV (or landmark array) is supplied.
  2. **Precomputed ROI stacks**: manifest key ``roi_npy`` imports
     externally-extracted crops verbatim.
  3. **Tracked Haar + motion localization** (this environment's native
     path, dlib unavailable): per-frame Haar face detections are
     interpolated across dropouts and temporally smoothed
     (``track_boxes``), and the mouth is localized inside the face box by
     the utterance's aggregated MOTION energy (``motion_mouth_center`` —
     during speech the mouth is the dominant mover in the lower face)
     rather than a fixed geometric prior alone.

Residual gap vs the reference tooling, stated honestly: path 3 has no
per-frame landmark fit, so extreme head pose/rotation and non-speech
motion (chewing, head bobs) degrade it where dlib/OpenFace would not;
paths 1-2 exist precisely so prepared landmarks restore full parity.
"""

from __future__ import annotations

import csv
import os
import wave
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from avsr_tpu_torch.data.synthetic import Utterance
from avsr_tpu_torch.data.tfrecord import TFRecordWriter, utterance_to_bytes


def _cv2(what: str):
    """OpenCV, imported where a function needs it."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"OpenCV (cv2) is required for {what}, and this Python has no cv2; "
            "prepare records on a host with cv2 installed, or pass prepared ROI "
            "arrays (manifest column roi_npy)") from e
    return cv2


# ---------------------------------------------------------------------------
# audio
# ---------------------------------------------------------------------------


def load_wav(path: str, target_rate: int = 16_000) -> np.ndarray:
    """Load a PCM wav file -> float32 [-1, 1], resampled to target_rate."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
    x = np.frombuffer(raw, dtype).astype(np.float32)
    if width == 1:
        x = (x - 128.0) / 128.0
    else:
        x = x / float(np.iinfo(dtype).max)
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    if rate != target_rate:
        x = resample_linear(x, rate, target_rate)
    return x


def resample_linear(x: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Linear-interpolation resampler (offline tooling quality bar)."""
    n_out = int(round(len(x) * dst_rate / src_rate))
    src_t = np.arange(len(x)) / src_rate
    dst_t = np.arange(n_out) / dst_rate
    return np.interp(dst_t, src_t, x).astype(np.float32)


def bank_from_wavs(
    paths: Sequence[str],
    row_samples: int = 160_000,
    target_rate: int = 16_000,
) -> np.ndarray:
    """Build an on-device noise bank [N, row_samples] from REAL recordings.

    The reference mixed recorded babble/cafe noise into fixed noisy TFRecord
    copies at dataset-writing time (SURVEY.md §5.9, upstream:avsr/
    dataset_writer.py); this framework instead stores clean waveforms plus a
    noise BANK and mixes at a runtime SNR inside the train step
    (avsr_tpu_torch/ops/noise.py).  This helper is the recorded-noise ingress:
    each wav is loaded (resampled to target_rate, channel-averaged) and cut
    into consecutive ``row_samples``-length rows; recordings shorter than
    one row are tiled up to a full row so short clips still contribute.
    Run once per noise TYPE (one bank file per type) for a typed
    babble/cafe bank — the eval matrix reports per-(type x SNR).

    Absolute level does not matter (mixing rescales by the energy ratio at
    the target SNR), but silent recordings are rejected loudly — a
    zero-energy row would make the SNR scale degenerate.
    """
    rows: List[np.ndarray] = []
    for path in paths:
        x = load_wav(path, target_rate=target_rate)
        if len(x) == 0 or not np.any(np.abs(x) > 1e-6):
            raise ValueError(
                f"noise recording {path!r} is empty or silent; a zero-energy"
                " bank row would break SNR mixing"
            )
        if len(x) < row_samples:
            reps = int(np.ceil(row_samples / len(x)))
            x = np.tile(x, reps)[:row_samples]
        n_rows = len(x) // row_samples
        for i in range(n_rows):
            rows.append(x[i * row_samples : (i + 1) * row_samples])
    if not rows:
        raise ValueError("no noise rows produced (empty wav list?)")
    return np.stack(rows).astype(np.float32)


# ---------------------------------------------------------------------------
# video: lip-ROI extraction
# ---------------------------------------------------------------------------


def _face_detector(cv2):
    """Best available face detector, or None for the geometric fallback.

    OpenCV 4 ships Haar cascades (cv2.CascadeClassifier); OpenCV 5 removed
    them in favor of DNN detectors that require model files we cannot assume
    offline.  With no detector every frame uses the lower-third center-crop
    heuristic — the same graceful degradation applied to failed detections.
    """
    if hasattr(cv2, "CascadeClassifier") and hasattr(cv2, "data"):
        xml = cv2.data.haarcascades + "haarcascade_frontalface_default.xml"
        if os.path.exists(xml):
            cascade = cv2.CascadeClassifier(xml)

            def detect(gray):
                return cascade.detectMultiScale(gray, 1.1, 4)

            return detect
    return None


def _resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Pure-NumPy bilinear resize (keeps the ROI core cv2-free/testable)."""
    h, w = img.shape
    if h == out_h and w == out_w:
        return img.astype(np.float32)
    ys = np.linspace(0.0, h - 1.0, out_h)
    xs = np.linspace(0.0, w - 1.0, out_w)
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0).astype(np.float32)[:, None]
    wx = (xs - x0).astype(np.float32)[None, :]
    img = img.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def track_boxes(
    detections: Sequence[Optional[Sequence[float]]],
    frame_hw: Tuple[int, int],
    smooth_window: int = 7,
) -> np.ndarray:
    """Per-frame (possibly missing) face detections -> a smooth track.

    Haar detections drop out and jitter frame to frame; the reference's
    landmark tracker was temporally stable.  This closes part of that gap:
    missing frames are linearly INTERPOLATED between surviving detections
    (extrapolation holds the nearest), then each box coordinate is smoothed
    with a centered moving average.

    Args:
      detections: length-T list of (x, y, w, h) or None per frame.
      frame_hw: (H, W) of the frames, for the no-detection fallback
        (centered lower-third region, the previous behavior).

    Returns float32 [T, 4] (x, y, w, h) per frame.
    """
    T = len(detections)
    H, W = frame_hw
    idx = [t for t, d in enumerate(detections) if d is not None]
    if not idx:
        box = np.asarray([W / 3.0, 2.0 * H / 3.0, W / 3.0, H / 3.0] , np.float32)
        return np.tile(box, (T, 1))
    det = np.asarray([detections[t] for t in idx], np.float32)  # [N, 4]
    track = np.empty((T, 4), np.float32)
    ts = np.arange(T, dtype=np.float32)
    for c in range(4):
        track[:, c] = np.interp(ts, np.asarray(idx, np.float32), det[:, c])
    if smooth_window > 1:
        k = smooth_window
        pad = k // 2
        padded = np.pad(track, ((pad, pad), (0, 0)), mode="edge")
        kernel = np.ones(k, np.float32) / k
        for c in range(4):
            track[:, c] = np.convolve(padded[:, c], kernel, mode="valid")[:T]
    return track


def motion_mouth_center(
    frames: np.ndarray,
    boxes: np.ndarray,
    grid: int = 48,
) -> Tuple[float, float]:
    """Locate the mouth INSIDE the tracked face box by motion energy.

    During speech the mouth is the dominant mover in the lower face, so the
    utterance-aggregated |frame difference| map (computed in box-normalized
    coordinates, restricted to the lower half of the face) peaks on it —
    an optical-flow-grade cue with no landmark model.  Returns the energy
    centroid as (cx, cy) fractions of the face box, clamped to the lower
    face so brow/eye motion can never capture it; falls back to the
    geometric prior (0.5, 5/6) for static clips.
    """
    T = frames.shape[0]
    energy = np.zeros((grid, grid), np.float32)
    prev = None
    for t in range(T):
        x, y, w, h = boxes[t]
        x0, y0 = int(round(x)), int(round(y))
        x1 = min(int(round(x + w)), frames.shape[2])
        y1 = min(int(round(y + h)), frames.shape[1])
        x0, y0 = max(x0, 0), max(y0, 0)
        if x1 <= x0 + 1 or y1 <= y0 + 1:
            prev = None
            continue
        crop = _resize_bilinear(
            frames[t, y0:y1, x0:x1].astype(np.float32), grid, grid
        )
        if prev is not None:
            energy += np.abs(crop - prev)
        prev = crop
    lower = energy[grid // 2 :, :]
    if float(lower.sum()) <= 1e-6:  # static clip: geometric lower-third prior
        return 0.5, 5.0 / 6.0
    # 3x3 box blur, then a PEAK-WINDOWED centroid: a global centroid is
    # biased by face-edge motion (the drifting box outline also produces
    # frame-difference energy); localizing around the strongest mover
    # keeps the mouth blob's own center.
    k = np.ones((3, 3), np.float32) / 9.0
    pad = np.pad(lower, 1, mode="edge")
    blur = np.zeros_like(lower)
    for dy in range(3):
        for dx in range(3):
            blur += k[dy, dx] * pad[dy : dy + lower.shape[0],
                                    dx : dx + lower.shape[1]]
    py, px = np.unravel_index(int(np.argmax(blur)), blur.shape)
    r = max(grid // 8, 2)
    y0, y1 = max(py - r, 0), min(py + r + 1, lower.shape[0])
    x0, x1 = max(px - r, 0), min(px + r + 1, lower.shape[1])
    win = blur[y0:y1, x0:x1]
    yy, xx = np.mgrid[y0:y1, x0:x1]
    total = float(win.sum())
    cy = (grid // 2 + float((yy * win).sum()) / total) / grid
    cx = float((xx * win).sum()) / total / grid
    return float(np.clip(cx, 0.2, 0.8)), float(np.clip(cy, 0.55, 0.95))


def rois_from_frames(
    frames: np.ndarray,
    detections: Sequence[Optional[Sequence[float]]],
    roi_size: int = 36,
    *,
    smooth_window: int = 7,
    use_motion: bool = True,
) -> np.ndarray:
    """Grayscale frames + per-frame detections -> [T, roi, roi, 1] crops.

    The full tracked pipeline: interpolate+smooth the face track, localize
    the mouth by motion energy, crop a w/2 x h/3 mouth window per frame,
    resize.  Pure NumPy so the geometry is unit-testable without cv2
    (tests/test_ingest.py pins ROI center error on synthetic video).
    """
    T, H, W = frames.shape[:3]
    frames = frames.reshape(T, H, W)
    boxes = track_boxes(detections, (H, W), smooth_window)
    if use_motion:
        cx, cy = motion_mouth_center(frames, boxes)
    else:
        cx, cy = 0.5, 5.0 / 6.0
    rois = np.empty((T, roi_size, roi_size, 1), np.float32)
    for t in range(T):
        x, y, w, h = boxes[t]
        mw, mh = w / 2.0, h / 3.0
        mx0 = x + cx * w - mw / 2.0
        my0 = y + cy * h - mh / 2.0
        x0 = int(np.clip(round(mx0), 0, max(W - 2, 0)))
        y0 = int(np.clip(round(my0), 0, max(H - 2, 0)))
        x1 = int(np.clip(round(mx0 + mw), x0 + 1, W))
        y1 = int(np.clip(round(my0 + mh), y0 + 1, H))
        mouth = frames[t, y0:y1, x0:x1]
        rois[t, :, :, 0] = _resize_bilinear(mouth, roi_size, roi_size)
    peak = float(rois.max())
    if peak > 1.0:  # uint8-range input
        rois /= 255.0
    return rois


def extract_lip_rois(
    video_path: str,
    roi_size: int = 36,
    max_frames: Optional[int] = None,
    *,
    smooth_window: int = 7,
    use_motion: bool = True,
) -> np.ndarray:
    """Video file -> [T, roi, roi, 1] float32 grayscale lip crops.

    Face detection via OpenCV Haar cascade, then the tracked pipeline
    (:func:`rois_from_frames`): dropout interpolation + temporal smoothing
    of the face track and motion-energy mouth localization.  With no
    detection anywhere, the centered lower-third fallback applies (the
    graceful degradation the reference tooling applied to failed landmark
    fits).  For reference-parity crops from dlib/OpenFace landmarks use
    :func:`rois_from_landmarks` instead.
    """
    cv2 = _cv2("ROI extraction")

    detect = _face_detector(cv2)
    frames: List[np.ndarray] = []
    detections: List[Optional[Tuple[int, int, int, int]]] = []
    cap = cv2.VideoCapture(video_path)
    while True:
        ok, frame = cap.read()
        if not ok or (max_frames and len(frames) >= max_frames):
            break
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        frames.append(gray)
        box = None
        if detect is not None:
            faces = detect(gray)
            if len(faces):
                box = tuple(max(faces, key=lambda b: b[2] * b[3]))
        detections.append(box)
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    return rois_from_frames(
        np.stack(frames), detections, roi_size,
        smooth_window=smooth_window, use_motion=use_motion,
    )


# ---------------------------------------------------------------------------
# video: landmark-based ROI (reference-parity path)
# ---------------------------------------------------------------------------

#: dlib/OpenFace 68-point convention: mouth landmarks are points 48-67.
MOUTH_LANDMARKS = slice(48, 68)


def load_openface_landmarks(csv_path: str) -> np.ndarray:
    """OpenFace output CSV (x_0..x_67 / y_0..y_67 columns) -> [T, 68, 2]."""
    with open(csv_path) as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    if not rows:
        raise ValueError(f"empty landmark csv {csv_path}")
    clean0 = {k.strip(): v for k, v in rows[0].items()}
    n_pts = sum(1 for k in clean0 if k.startswith("x_"))
    if n_pts < 68:
        raise ValueError(
            f"{csv_path} has {n_pts} landmark x-columns; expected the "
            "68-point dlib/OpenFace convention"
        )
    out = np.zeros((len(rows), 68, 2), np.float32)
    for i, row in enumerate(rows):
        clean = {k.strip(): v for k, v in row.items()}
        for p in range(68):
            out[i, p, 0] = float(clean[f"x_{p}"])
            out[i, p, 1] = float(clean[f"y_{p}"])
    return out


def rois_from_landmarks(
    frames: np.ndarray,
    landmarks: np.ndarray,
    roi_size: int = 36,
    *,
    margin: float = 0.30,
    smooth_window: int = 5,
) -> np.ndarray:
    """Frames + 68-point landmarks -> mouth crops (reference-parity path).

    Crops the square bounding box of the mouth landmark hull (points
    48-67) expanded by ``margin``, with the same temporal smoothing the
    tracked pipeline uses.  This is the crop geometry the reference's
    dlib/OpenFace tooling produced; feed it OpenFace CSVs via
    :func:`load_openface_landmarks` (SURVEY §2.2 row 15).
    """
    T, H, W = frames.shape[:3]
    frames = frames.reshape(T, H, W)
    if landmarks.shape[0] != T:
        raise ValueError(
            f"landmark frames ({landmarks.shape[0]}) != video frames ({T})"
        )
    mouth = landmarks[:, MOUTH_LANDMARKS, :]  # [T, 20, 2]
    lo = mouth.min(axis=1)  # [T, 2] (x, y)
    hi = mouth.max(axis=1)
    center = (lo + hi) / 2.0
    side = (hi - lo).max(axis=1) * (1.0 + margin)  # [T]
    side = np.maximum(side, 4.0)
    boxes = [
        (center[t, 0] - side[t] / 2.0, center[t, 1] - side[t] / 2.0,
         side[t], side[t])
        for t in range(T)
    ]
    track = track_boxes(boxes, (H, W), smooth_window)
    rois = np.empty((T, roi_size, roi_size, 1), np.float32)
    for t in range(T):
        x, y, w, h = track[t]
        x0 = int(np.clip(round(x), 0, max(W - 2, 0)))
        y0 = int(np.clip(round(y), 0, max(H - 2, 0)))
        x1 = int(np.clip(round(x + w), x0 + 1, W))
        y1 = int(np.clip(round(y + h), y0 + 1, H))
        rois[t, :, :, 0] = _resize_bilinear(
            frames[t, y0:y1, x0:x1], roi_size, roi_size
        )
    if float(rois.max()) > 1.0:  # uint8-range input
        rois /= 255.0
    return rois


def extract_lip_rois_from_landmarks(
    video_path: str,
    landmarks_csv: str,
    roi_size: int = 36,
    max_frames: Optional[int] = None,
) -> np.ndarray:
    """Video + OpenFace landmark CSV -> reference-parity mouth crops."""
    cv2 = _cv2("video decoding")
    cap = cv2.VideoCapture(video_path)
    frames: List[np.ndarray] = []
    while True:
        ok, frame = cap.read()
        if not ok or (max_frames and len(frames) >= max_frames):
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    lms = load_openface_landmarks(landmarks_csv)[: len(frames)]
    return rois_from_landmarks(np.stack(frames), lms, roi_size)


# ---------------------------------------------------------------------------
# OpenFace action units
# ---------------------------------------------------------------------------


def load_openface_aus(
    csv_path: str, au_columns: Optional[Sequence[str]] = None
) -> np.ndarray:
    """OpenFace output CSV -> [T, au_dim] AU intensity matrix.

    Default columns: all ``AU*_r`` intensity outputs (the TASLP-2020
    experiments regress AU intensities from the attended visual context).
    """
    with open(csv_path) as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    if not rows:
        raise ValueError(f"empty AU csv {csv_path}")
    keys = [k.strip() for k in rows[0].keys()]
    if au_columns is None:
        au_columns = [k for k in keys if k.startswith("AU") and k.endswith("_r")]
    if not au_columns:
        raise ValueError(f"no AU intensity columns in {csv_path}")
    out = np.zeros((len(rows), len(au_columns)), np.float32)
    for i, row in enumerate(rows):
        clean = {k.strip(): v for k, v in row.items()}
        for j, c in enumerate(au_columns):
            out[i, j] = float(clean[c])
    return out


# ---------------------------------------------------------------------------
# corpus -> records
# ---------------------------------------------------------------------------


def build_utterance(
    uid: str,
    transcript: str,
    wav_path: Optional[str] = None,
    video_path: Optional[str] = None,
    au_csv_path: Optional[str] = None,
    *,
    sample_rate: int = 16_000,
    roi_size: int = 36,
    landmarks_csv_path: Optional[str] = None,
    roi_npy_path: Optional[str] = None,
) -> Utterance:
    """ROI source precedence (best available wins): precomputed ROI stack
    (``roi_npy_path``) > OpenFace landmarks (``landmarks_csv_path``, the
    reference-parity crop) > tracked Haar + motion localization."""
    video = None
    if roi_npy_path:
        video = np.load(roi_npy_path).astype(np.float32)
        if video.ndim == 3:
            video = video[..., None]
        if float(video.max()) > 1.0:
            video = video / 255.0
    elif video_path and landmarks_csv_path:
        video = extract_lip_rois_from_landmarks(
            video_path, landmarks_csv_path, roi_size
        )
    elif video_path:
        video = extract_lip_rois(video_path, roi_size)
    return Utterance(
        uid=uid,
        transcript=transcript,
        waveform=load_wav(wav_path, sample_rate) if wav_path else None,
        video=video,
        au=load_openface_aus(au_csv_path) if au_csv_path else None,
    )


def write_corpus(
    manifest: List[Dict[str, str]],
    out_path: str,
    video_codec: str = "uint8",
    num_shards: int = 1,
    log_every: int = 0,
    **kw,
) -> int:
    """Manifest rows -> TFRecord file(s), STREAMING (one utterance in
    memory at a time — a multi-GB corpus writes with bounded RSS).

    Row keys: ``uid``, ``transcript``, and optionally ``wav``, ``video``,
    ``au_csv``, ``landmarks_csv`` (OpenFace landmark crops — the
    reference-parity ROI path), ``roi_npy`` (externally-extracted ROI
    stack imported verbatim).

    Lip-ROI crops are grayscale in [0, 1], so the default codec quantizes
    them to uint8 (4x smaller records); pass ``video_codec="float32"`` for
    bit-exact storage.  ``num_shards > 1`` splits contiguous manifest
    chunks into ``{out_path}-{i:05d}-of-{n:05d}`` (the same layout as
    ``tfrecord.write_dataset``, readable via the shard glob).
    """
    n = len(manifest)
    if num_shards <= 1:
        bounds = [(out_path, 0, n)]
    else:
        per = -(-n // num_shards)
        bounds = [
            (f"{out_path}-{i:05d}-of-{num_shards:05d}",
             i * per, min((i + 1) * per, n))
            for i in range(num_shards)
        ]
    written = 0
    for shard_path, lo, hi in bounds:
        with TFRecordWriter(shard_path) as w:
            for row in manifest[lo:hi]:
                u = build_utterance(
                    row["uid"], row["transcript"],
                    row.get("wav"), row.get("video"), row.get("au_csv"),
                    landmarks_csv_path=row.get("landmarks_csv"),
                    roi_npy_path=row.get("roi_npy"),
                    **kw,
                )
                w.write(utterance_to_bytes(u, video_codec=video_codec))
                written += 1
                if log_every and written % log_every == 0:
                    print(f"  {written}/{n} utterances written", flush=True)
    return written


# Manifest columns interpreted as filesystem paths (resolved relative to
# the manifest file's directory) — everything else passes through verbatim.
_MANIFEST_PATH_COLUMNS = (
    "wav", "video", "au_csv", "landmarks_csv", "roi_npy", "transcript_file",
)


def read_manifest(path: str) -> List[Dict[str, str]]:
    """Corpus manifest CSV/TSV -> ``write_corpus`` rows.

    Header row names the columns; ``uid`` is required, plus any of
    ``transcript``, ``transcript_file`` (read + stripped at parse time —
    the LRS2-style one-transcript-file-per-clip layout), ``wav``,
    ``video``, ``au_csv``, ``landmarks_csv``, ``roi_npy``.  Relative
    paths resolve against the manifest's own directory, so a manifest
    can live next to its media and move with it.  The delimiter is
    sniffed from the header (tab if the header contains one, else comma).
    """
    base = os.path.dirname(os.path.abspath(path))
    with open(path, newline="") as f:
        head = f.readline()
        if not head.strip():
            raise ValueError(f"empty manifest {path!r}")
        delim = "\t" if "\t" in head else ","
        f.seek(0)
        reader = csv.DictReader(f, delimiter=delim)
        if reader.fieldnames is None or "uid" not in reader.fieldnames:
            raise ValueError(
                f"manifest {path!r} needs a header row with a 'uid' column "
                f"(got {reader.fieldnames})"
            )
        rows: List[Dict[str, str]] = []
        for i, raw in enumerate(reader):
            row = {
                k.strip(): v.strip()
                for k, v in raw.items()
                if k is not None and v is not None and v.strip()
            }
            if not row.get("uid"):
                raise ValueError(f"manifest row {i + 2}: empty uid")
            for col in _MANIFEST_PATH_COLUMNS:
                if col in row and not os.path.isabs(row[col]):
                    row[col] = os.path.join(base, row[col])
            tf_path = row.pop("transcript_file", None)
            if tf_path is not None:
                if "transcript" in row:
                    raise ValueError(
                        f"manifest row {i + 2} ({row['uid']}): both "
                        "'transcript' and 'transcript_file' given"
                    )
                with open(tf_path) as tf:
                    text = tf.read().strip()
                # LRS2 transcript files lead with "Text:  <words>"
                if text.lower().startswith("text:"):
                    text = text[5:].split("\n")[0].strip()
                row["transcript"] = text
            row.setdefault("transcript", "")
            rows.append(row)
    return rows
