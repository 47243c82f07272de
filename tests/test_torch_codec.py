"""Port parity, the datagen frame codec: ``parallel.codec`` of the torch
package against ``wgpu_physics_engine_tpu/parallel/codec.py`` (CPU).

Tolerances: ``encode`` gives the same int8 coefficients except ±1 where a
quantized coefficient sits at a rounding tie (the two 8×8 DCTs sum in
another order, so ``kept / q`` may land on either side of .5), on >= 99.9%
of coefficients exactly. ``decode``, the sidecar and ``psnr`` are copies of
the JAX module's NumPy code and agree byte for byte.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu.parallel import codec as JC
from wgpu_physics_engine_torch.parallel import codec as TC


def _frames(seed, lead=(3,), h=24, w=32, noise=12.0):
    """Smooth gradients plus noise and a few hard edges, uint8."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 128 + 60 * np.sin(x / 5.0)[..., None] * np.cos(y / 7.0)[..., None]
    img = base + rng.normal(0, noise, lead + (h, w, 3))
    img[..., h // 3:h // 2, w // 4:w // 2, 0] = 250.0      # a red block
    return np.clip(img, 0, 255).astype(np.uint8)


def test_tables_are_the_jax_tables():
    np.testing.assert_array_equal(TC._QTABLE, JC._QTABLE)
    np.testing.assert_array_equal(TC._DCT, JC._DCT)
    np.testing.assert_array_equal(TC._ZZ, JC._ZZ)
    assert TC.CODEC_VERSION == JC.CODEC_VERSION
    for k in (1, 16, 64):
        np.testing.assert_array_equal(TC._quant(k, 1.5), JC._quant(k, 1.5))


@pytest.mark.parametrize("k,quality", [(16, 1.0), (8, 2.0), (64, 1.0)])
def test_encode_matches_jax(k, quality):
    imgs = _frames(k)
    got = TC.encode(torch.tensor(imgs), k=k, quality=quality).numpy()
    ref = np.asarray(JC.encode(jnp.asarray(imgs), k=k, quality=quality))
    assert got.dtype == np.int8 and got.shape == ref.shape == (3, 3, 4, 3, k)
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.999, (d == 0).mean()


def test_encode_takes_float_frames_and_any_leading_axes():
    imgs = _frames(5, lead=(2, 2), h=16, w=16)
    got = TC.encode(torch.tensor(imgs.astype(np.float32)), k=16)
    assert got.shape == (2, 2, 2, 2, 3, 16)
    ref = TC.encode(torch.tensor(imgs), k=16)
    assert torch.equal(got, ref)
    before = torch.backends.cuda.matmul.allow_tf32
    TC.encode(torch.tensor(imgs), k=16)
    assert torch.backends.cuda.matmul.allow_tf32 == before


@pytest.mark.parametrize("k,quality", [(16, 1.0), (4, 1.5)])
def test_decode_is_byte_identical(k, quality):
    enc = np.asarray(JC.encode(jnp.asarray(_frames(9)), k=k, quality=quality))
    got = TC.decode(enc, quality=quality)
    ref = JC.decode(enc, quality=quality)
    assert got.dtype == np.uint8 and got.tobytes() == ref.tobytes()


def test_roundtrip_psnr_and_psnr_matches_jax():
    imgs = _frames(11, noise=2.0)
    dec = TC.decode(TC.encode(torch.tensor(imgs), k=16).numpy())
    p = TC.psnr(imgs, dec)
    assert p == JC.psnr(imgs, dec)
    assert p >= 28.0, p
    assert TC.psnr(imgs, imgs) == float("inf") == JC.psnr(imgs, imgs)


def test_meta_sidecar_byte_identical(tmp_path):
    a, b = tmp_path / "torch", tmp_path / "jax"
    a.mkdir()
    b.mkdir()
    pa = TC.write_meta(str(a), 16, 1.25, (256, 256))
    pb = JC.write_meta(str(b), 16, 1.25, (256, 256))
    assert os.path.basename(pa) == os.path.basename(pb) == "codec_meta.json"
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()
    assert TC.read_meta(str(b)) == JC.read_meta(str(a))
    with open(pa, "w") as f:
        f.write('{"codec_version": 99, "k": 16}')
    with pytest.raises(ValueError):
        TC.read_meta(str(a))
    with pytest.raises(FileNotFoundError):
        TC.read_meta(str(tmp_path))
