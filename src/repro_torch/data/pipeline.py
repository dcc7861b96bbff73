"""Deterministic synthetic data pipelines (token LM + CIFAR-shaped images).

A copy of the JAX package's ``data/pipeline.py`` (numpy only): the arrays
are equal to the reference's by construction.

No datasets ship with this container, so the pipelines generate procedural
data with real-pipeline properties: stateless indexing (any step can be
regenerated from (seed, step) — this is what makes data-state checkpointing
and elastic rescaling exact), per-host sharding, and prefetch-free pure
functions.

The LM stream is a mixture of Zipfian unigrams and deterministic motifs so a
model can actually reduce loss on it; the image task is a 10-class
procedural shape/texture problem of CIFAR shape (32x32x3) for the paper's
ViT experiment.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    vocab_size: int = 512
    seq_len: int = 128
    global_batch: int = 8


# --------------------------------------------------------------------- LM


def lm_batch(cfg: DataConfig, step: int, host_id: int = 0, n_hosts: int = 1
             ) -> Dict[str, np.ndarray]:
    """Batch for a given step; sharded by host; stateless in (seed, step)."""
    per_host = cfg.global_batch // n_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host_id]))
    v = cfg.vocab_size
    # zipfian unigrams
    ranks = np.arange(1, v + 1)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = rng.choice(v, size=(per_host, cfg.seq_len + 1), p=probs)
    # inject deterministic motifs (learnable bigram structure)
    motif = (np.arange(cfg.seq_len + 1) * 7 + 13) % v
    mask = rng.random((per_host, cfg.seq_len + 1)) < 0.5
    toks = np.where(mask, motif[None, :], toks)
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


def lm_stream(cfg: DataConfig, start_step: int = 0, host_id: int = 0,
              n_hosts: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield lm_batch(cfg, step, host_id, n_hosts)
        step += 1


# ------------------------------------------------------------------ images


def image_batch(cfg: DataConfig, step: int, split: str = "train"
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Procedural 10-class 32x32x3 task (the CIFAR stand-in; DESIGN.md §9).

    Class k draws a textured background plus k-dependent geometry (stripe
    angle, blob position, colour balance) with noise — hard enough that a
    ViT needs real features, easy enough to reach high accuracy in a few
    hundred steps.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed + (0 if split == "train" else 77), step]))
    b = cfg.global_batch
    labels = rng.integers(0, 10, size=(b,))
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 32.0
    imgs = np.empty((b, 32, 32, 3), np.float32)
    for i, k in enumerate(labels):
        angle = k * np.pi / 10.0
        stripes = 0.5 + 0.5 * np.sin(
            2 * np.pi * ((np.cos(angle) * xx + np.sin(angle) * yy) * (2 + k % 3)))
        cx, cy = 0.2 + 0.06 * k, 0.8 - 0.06 * k
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.02))
        base = np.stack([
            stripes * (0.3 + 0.07 * (k % 4)),
            blob,
            1.0 - stripes * (0.2 + 0.05 * (k % 5)),
        ], axis=-1)
        imgs[i] = base + rng.normal(0, 0.15, size=(32, 32, 3))
    return np.clip(imgs, 0.0, 1.0).astype(np.float32), labels.astype(np.int32)


@dataclasses.dataclass
class PipelineState:
    """Checkpointable data-pipeline position."""

    step: int = 0

    def to_dict(self):
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(step=int(d["step"]))
