"""MNIST-class data for the paper's MLP (Sec. III-A), in numpy.

``synthetic_mnist`` makes a deterministic 10-class set of 28x28 8-bit
grayscale images from a seed (smooth class prototypes, a per-sample
shift, jitter and noise); ``paper_dataset`` pads it as the paper does:
inputs 784 -> 1024 with zeros, labels one-hot 10 -> 32.  Real MNIST idx
files are read instead where they lie on this machine (``data/mnist/``
under the working directory, or ``$MNIST_DIR``).
"""
from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

PAPER_EPOCH = 12544    # inputs per epoch (Sec. III-B)


def _prototypes() -> np.ndarray:
    """10 smooth, well-separated 28x28 prototypes (digit stand-ins)."""
    yy, xx = np.mgrid[0:28, 0:28] / 27.0
    protos = []
    for c in range(10):
        rngc = np.random.default_rng(1000 + c)
        img = np.zeros((28, 28))
        for _ in range(4):  # a few gaussian strokes per class
            cx, cy = rngc.uniform(0.15, 0.85, 2)
            sx, sy = rngc.uniform(0.04, 0.18, 2)
            amp = rngc.uniform(0.6, 1.0)
            img += amp * np.exp(-((xx - cx) ** 2 / (2 * sx ** 2)
                                  + (yy - cy) ** 2 / (2 * sy ** 2)))
        protos.append(img / img.max())
    return np.stack(protos)


def synthetic_mnist(n: int = PAPER_EPOCH, seed: int = 0,
                    noise: float = 0.15) -> tuple[np.ndarray, np.ndarray]:
    """(images [n, 784] float32 in [0, 1], labels [n] int32)."""
    rng = np.random.default_rng(seed)
    protos = _prototypes()
    labels = rng.integers(0, 10, size=n)
    imgs = protos[labels]
    # per-sample shift (up to 2 px), multiplicative jitter, noise
    out = np.empty((n, 28, 28), np.float32)
    shifts = rng.integers(-2, 3, size=(n, 2))
    for i in range(n):
        out[i] = np.roll(imgs[i], tuple(shifts[i]), axis=(0, 1))
    out *= rng.uniform(0.7, 1.0, size=(n, 1, 1)).astype(np.float32)
    out += noise * rng.standard_normal((n, 28, 28)).astype(np.float32)
    out = np.clip(out, 0.0, 1.0)
    # 8-bit grayscale, like the real set
    out = np.round(out * 255.0) / 255.0
    return out.reshape(n, 784), labels.astype(np.int32)


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        return np.frombuffer(f.read(), np.uint8).reshape(dims)


def real_mnist(root: str | None = None):
    """(images [N, 784] in [0, 1], labels [N]), or None where the idx files
    are absent."""
    root = Path(root or os.environ.get("MNIST_DIR", "data/mnist"))
    for imgs_name, lbl_name in [
            ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
            ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz")]:
        ip, lp = root / imgs_name, root / lbl_name
        if ip.exists() and lp.exists():
            x = _read_idx(ip).astype(np.float32).reshape(-1, 784) / 255.0
            y = _read_idx(lp).astype(np.int32)
            return x, y
    return None


def paper_dataset(n: int = PAPER_EPOCH, seed: int = 0):
    """Padded per Sec. III-A: (x [n, 1024], one-hot y [n, 32], labels)."""
    real = real_mnist()
    if real is not None:
        x, y = real
        x, y = x[:n], y[:n]
    else:
        x, y = synthetic_mnist(n, seed)
    xp = np.zeros((x.shape[0], 1024), np.float32)
    xp[:, :784] = x
    yp = np.zeros((x.shape[0], 32), np.float32)
    yp[np.arange(x.shape[0]), y] = 1.0
    return xp, yp, y
