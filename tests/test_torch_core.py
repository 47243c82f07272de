"""Port parity, core layer: the torch package's config, topology and state
against the JAX package's (CPU), plus the port's dispatch rules: it never
imports jax, a CUDA request on a host without CUDA fails loudly, and the
exported constructors put their tensors on the card unless the caller names
another device."""

import dataclasses
import inspect
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.core import state as jstate
from wgpu_physics_engine_tpu.core import topology as jtopo
from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.core import state as tstate
from wgpu_physics_engine_torch.core import topology as ttopo
from wgpu_physics_engine_torch.ops import cloth_kernel, raster_kernel
from wgpu_physics_engine_torch.parallel import datagen as tdatagen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["ClothConfig", "CameraConfig",
                                  "LightConfig", "GlobeConfig",
                                  "FreeParticleConfig"])
def test_config_dataclasses_match_field_for_field(name):
    a, b = getattr(jcfg, name), getattr(tcfg, name)
    fa = [(f.name, f.default) for f in dataclasses.fields(a)]
    fb = [(f.name, f.default) for f in dataclasses.fields(b)]
    assert fa == fb
    assert dataclasses.astuple(a()) == dataclasses.astuple(b())


def test_cloth_config_derived_lengths_match():
    for hw in [(60, 60), (16, 24)]:
        a = jcfg.ClothConfig(height=hw[0], width=hw[1])
        b = tcfg.ClothConfig(height=hw[0], width=hw[1])
        for prop in ("spacing", "rest_struct", "rest_shear", "rest_bend",
                     "num_particles"):
            assert getattr(a, prop) == getattr(b, prop)


@pytest.mark.parametrize("hw", [(16, 16), (12, 20)])
def test_topology_copy_matches(hw):
    h, w = hw
    assert ttopo.spring_counts(h, w) == jtopo.spring_counts(h, w)
    pos = np.random.default_rng(0).normal(size=(h * w, 3)).astype(np.float32)
    for x, y in zip(ttopo.build_spring_lists(pos, h, w),
                    jtopo.build_spring_lists(pos, h, w)):
        np.testing.assert_array_equal(x, y)


def test_params_from_config_bitwise():
    c = tcfg.ClothConfig(height=24, width=32, gravity=-3.7, mu=0.35)
    jc = jcfg.ClothConfig(height=24, width=32, gravity=-3.7, mu=0.35)
    got = tstate.ClothParams.from_config(c, device="cpu")
    ref = jstate.ClothParams.from_config(jc)
    assert got._fields == ref._fields
    for f in got._fields:
        g, r = getattr(got, f), np.asarray(getattr(ref, f))
        assert g.dtype == torch.float32 and g.shape == ()
        assert g.numpy().tobytes() == r.tobytes(), f


@pytest.mark.parametrize("hw", [(16, 16), (24, 32), (60, 60)])
def test_init_cloth_state_bitwise(hw):
    c = tcfg.ClothConfig(height=hw[0], width=hw[1], center=(0.3, 12.0, -1.7))
    jc = jcfg.ClothConfig(height=hw[0], width=hw[1], center=(0.3, 12.0, -1.7))
    got = tstate.init_cloth_state(c, device="cpu")
    ref = jstate.init_cloth_state(jc)
    assert got.pos.dtype == torch.float32 and tuple(got.pos.shape) == (3, *hw)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))
    np.testing.assert_array_equal(got.vel.numpy(), np.asarray(ref.vel))
    assert got.pin_mask is None and got.pin_pos is None


def test_numpy_round_trip_bitwise():
    jc = jcfg.ClothConfig(height=16, width=16)
    ref_p = jstate.ClothParams.from_config(jc)
    s = jstate.init_cloth_state(jc)
    rng = np.random.default_rng(5)
    pin = np.zeros((16, 16), bool)
    pin[0] = True
    s = s._replace(vel=jnp.asarray(rng.normal(size=(3, 16, 16)), jnp.float32),
                   pin_mask=jnp.asarray(pin), pin_pos=s.pos)
    p = tstate.params_from_numpy(ref_p._replace(
        **{f: np.asarray(getattr(ref_p, f)) for f in ref_p._fields}),
        device="cpu")
    st = tstate.state_from_numpy(jstate.ClothState(
        *(None if a is None else np.asarray(a) for a in s)), device="cpu")
    for f in ref_p._fields:
        assert getattr(p, f).numpy().tobytes() == \
            np.asarray(getattr(ref_p, f)).tobytes()
    for a, b in zip(st, s):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert st.pin_mask.dtype == torch.bool
    bare = tstate.state_from_numpy(jstate.init_cloth_state(jc), device="cpu")
    assert bare.pin_mask is None and bare.pin_pos is None


def test_port_never_imports_jax_and_cpu_path_launches_nothing(tmp_path):
    """The package and its CLI, driven on the CPU in a fresh interpreter:
    jax is never imported, and the CPU path launches no kernel."""
    out = tmp_path / "cloth.png"
    code = (
        "import sys\n"
        "import wgpu_physics_engine_torch as P\n"
        "from wgpu_physics_engine_torch.__main__ import main\n"
        "from wgpu_physics_engine_torch.ops import cloth_kernel, raster_kernel\n"
        f"rc = main(['cloth', '--grid', '8', '--size', '16', '128',"
        f" '--seconds', '0.05', '--out', {str(out)!r}, '--device', 'cpu'])\n"
        "assert rc == 0, rc\n"
        "assert 'jax' not in sys.modules\n"
        "assert cloth_kernel.LAUNCHES == 0 and raster_kernel.LAUNCHES == 0\n"
        "print('OK')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(tmp_path), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
    assert out.exists()


def test_cli_cuda_without_cuda_fails_loudly(capsys):
    """No hidden fallback: the default ``--device cuda`` on a host without
    CUDA exits non-zero with a message instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    from wgpu_physics_engine_torch.__main__ import main

    rc = main(["cloth", "--grid", "8", "--seconds", "0.01"])
    assert rc != 0
    assert "CUDA is not available" in capsys.readouterr().err


def test_wrappers_refuse_other_devices():
    """A wrapper takes the plain version only for CPU tensors; any other
    device raises instead of falling back."""
    c = tcfg.ClothConfig(height=8, width=8)
    s = tstate.init_cloth_state(c, device="meta")
    p = tstate.ClothParams.from_config(c, device="meta")
    with pytest.raises(ValueError):
        cloth_kernel.multi_step(s, p, 1 / 480, 2)
    dirs = torch.empty((3, 8, 128), device="meta")
    ocb = torch.empty((4, 5), device="meta")
    wins = torch.empty((1, 8), dtype=torch.int32, device="meta")
    rect = torch.empty((4, 5), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        raster_kernel.sphere_raster_binned(wins, ocb, rect, dirs,
                                           torch.tensor(0.1, device="meta"))
    with pytest.raises(ValueError):
        cloth_kernel.multi_step_kernel(
            tstate.init_cloth_state(c, device="cpu"), p, 0.01, 1)
    assert cloth_kernel.LAUNCHES == 0 and raster_kernel.LAUNCHES == 0


@pytest.mark.parametrize("fn", [
    tstate.init_cloth_state, tstate.ClothParams.from_config,
    tstate.ParticleParams.from_config, tstate.params_from_numpy,
    tstate.state_from_numpy, tstate.particle_state_from_numpy,
    tstate.particle_params_from_numpy, tdatagen.world_batch_from_numpy],
    ids=lambda fn: fn.__qualname__)
def test_constructors_default_to_the_card(fn):
    """Every exported constructor defaults to ``device="cuda"``, as the
    scenes and the CLI do; the tests pass ``device="cpu"``."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"
