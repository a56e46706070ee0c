"""The benchmark's frames: a frozen copy of the program's synthetic video
generator (``data/video.py``), so that a change to the program cannot
change the benchmark's inputs; for the same seed the frames are
bit-equal.  Each class c is an oriented grating + blob pattern; each
video fixes (class, difficulty, phase drift); each frame adds background
clutter and noise scaled by difficulty.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class VideoDataConfig:
    n_classes: int = 10
    img_res: int = 32
    frames_per_video: int = 30
    class_difficulty: tuple = ()  # len n_classes in [0,1]; default ramp
    noise_floor: float = 0.15

    def difficulties(self) -> np.ndarray:
        if self.class_difficulty:
            return np.asarray(self.class_difficulty, np.float32)
        return np.linspace(0.05, 0.9, self.n_classes).astype(np.float32)


def _class_pattern(c: int, res: int, n_classes: int) -> np.ndarray:
    """Deterministic class template: oriented grating + offset blob."""
    yy, xx = np.mgrid[0:res, 0:res].astype(np.float32) / res
    ang = np.pi * c / n_classes
    freq = 3.0 + 2.0 * (c % 4)
    grating = np.sin(2 * np.pi * freq * (xx * np.cos(ang) + yy * np.sin(ang)))
    cx, cy = 0.3 + 0.4 * ((c * 37) % 10) / 10.0, 0.3 + 0.4 * ((c * 53) % 10) / 10.0
    blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.02))
    base = 0.6 * grating + 1.2 * blob
    rgb = np.stack([base * (0.5 + 0.5 * np.cos(c)), base * (0.5 + 0.5 * np.sin(1 + c)), base], -1)
    return rgb.astype(np.float32)


def make_video(cfg: VideoDataConfig, video_id: int, rng: np.random.Generator):
    """Returns (frames (F,R,R,3) f32, label, difficulty)."""
    label = int(rng.integers(cfg.n_classes))
    dbase = cfg.difficulties()[label]
    difficulty = float(np.clip(dbase + 0.15 * rng.standard_normal(), 0.0, 1.0))
    pattern = _class_pattern(label, cfg.img_res, cfg.n_classes)
    frames = []
    drift = rng.standard_normal(2) * 2
    for f in range(cfg.frames_per_video):
        shift = (drift * f).astype(int)
        img = np.roll(pattern, tuple(shift % cfg.img_res), axis=(0, 1))
        # clutter: a competing class pattern mixed in as difficulty grows
        distract = _class_pattern(int(rng.integers(cfg.n_classes)), cfg.img_res, cfg.n_classes)
        img = (1 - 0.75 * difficulty) * img + 0.75 * difficulty * distract
        img = img + (cfg.noise_floor + 0.6 * difficulty) * rng.standard_normal(img.shape).astype(np.float32)
        frames.append(img)
    return np.stack(frames), label, difficulty


def make_dataset(cfg: VideoDataConfig, n_videos: int, seed: int = 0):
    """Returns dict(frames (N,R,R,3), labels (N,), video_id (N,), difficulty (N,))."""
    rng = np.random.default_rng(seed)
    frames, labels, vids, diffs = [], [], [], []
    for v in range(n_videos):
        fr, lb, df = make_video(cfg, v, rng)
        frames.append(fr)
        labels += [lb] * len(fr)
        vids += [v] * len(fr)
        diffs += [df] * len(fr)
    return {
        "frames": np.concatenate(frames).astype(np.float32),
        "labels": np.asarray(labels, np.int32),
        "video_id": np.asarray(vids, np.int32),
        "difficulty": np.asarray(diffs, np.float32),
    }
