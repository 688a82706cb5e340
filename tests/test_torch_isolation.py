"""ceph_tpu_torch stands alone: it imports neither JAX nor the JAX
package, and its entry points run on the card unless the caller asks
for the CPU."""

import asyncio
import os
import re
import subprocess
import sys

import pytest
import torch

import ceph_tpu_torch
from ceph_tpu_torch.device.runtime import DeviceRuntime
from ceph_tpu_torch.ec import new_codec
from ceph_tpu_torch.models.crushmap import (CHOOSELEAF_FIRSTN, EMIT,
                                            STRAW2, TAKE, UNIFORM, CrushMap)
from ceph_tpu_torch.ops.crush.device import DeviceMapper, OutOfDeviceScope
from ceph_tpu_torch.osd.osdmap import (OSD_EXISTS, OSD_UP, Incremental,
                                       OSDMap, PGPool)
from ceph_tpu_torch.parallel.mapping import OSDMapMapping

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ceph_tpu_torch")
_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|ceph_tpu)\b(?!_torch)|"
    r"from\s+(jax|ceph_tpu)\b(?!_torch)[\w.]*\s+import)", re.M)


def test_import_pulls_in_no_jax_and_no_reference_package():
    code = (
        "import sys\n"
        "import ceph_tpu_torch, ceph_tpu_torch.ec, "
        "ceph_tpu_torch.ec.batcher, ceph_tpu_torch.device.stream\n"
        "import ceph_tpu_torch.ec.plugins.isa, "
        "ceph_tpu_torch.ec.plugins.jerasure, "
        "ceph_tpu_torch.ec.plugins.lrc, ceph_tpu_torch.ec.plugins.shec, "
        "ceph_tpu_torch.ec.plugins.clay\n"
        "import ceph_tpu_torch.ops.crush.device, "
        "ceph_tpu_torch.osd.osdmap, ceph_tpu_torch.parallel.mapping\n"
        "import ceph_tpu_torch.device.digest, "
        "ceph_tpu_torch.device.lzkernel, ceph_tpu_torch.compress, "
        "ceph_tpu_torch.compress.tlz, ceph_tpu_torch.dedup\n"
        "import ceph_tpu_torch.scale, ceph_tpu_torch.scale.balancer, "
        "ceph_tpu_torch.osd.balancer, ceph_tpu_torch.cli.osdmaptool, "
        "ceph_tpu_torch.trace.recorder, ceph_tpu_torch.utils.exporter, "
        "ceph_tpu_torch.utils.backoff\n"
        "bad = [m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m.startswith('jaxlib') "
        "or m == 'ceph_tpu' or m.startswith('ceph_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    for script in ("chip_smoke.py", "ec_times.py", "crush_times.py",
                   os.path.join("tools", "k3_tiles.py")):
        yield os.path.join(ROOT, script)


def test_sources_import_no_jax_and_no_reference_package():
    seen = 0
    for path in _sources():
        with open(path) as fh:
            text = fh.read()
        seen += 1
        assert not _FORBIDDEN.search(text), path
        # relative imports must stay inside the package
        assert "from ...." not in text, path
    assert seen >= 15


def test_forbidden_pattern_catches_reference_imports():
    for line in ("import jax", "import jax.numpy as jnp",
                 "from jax import numpy", "import ceph_tpu",
                 "from ceph_tpu.ec import gf", "  from ceph_tpu import x"):
        assert _FORBIDDEN.search(line), line
    for line in ("import ceph_tpu_torch", "from ceph_tpu_torch.ec import x",
                 "# see ceph_tpu/ec/kernels.py"):
        assert not _FORBIDDEN.search(line), line


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ceph_tpu_torch.default_device()
    with pytest.raises(RuntimeError):
        ceph_tpu_torch.default_device("cuda")
    assert ceph_tpu_torch.default_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        ceph_tpu_torch.default_device("meta")


def test_entry_points_raise_without_a_card(monkeypatch):
    """No card and no device="cpu": the async path raises rather than
    running on the CPU; the CPU runs only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    codec = new_codec({"plugin": "isa", "k": "4", "m": "2"})
    data = bytes(range(200)) * 40

    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(codec.encode_async(set(range(6)), data))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(codec.delta_async({0: b"\x01" * 64}))

    async def runtime():
        return DeviceRuntime.get()

    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(runtime())
    from ceph_tpu_torch.ec import kernels
    with pytest.raises(RuntimeError):
        kernels.FusedEncoder([[1, 1]])
    cpu = new_codec({"plugin": "isa", "k": "4", "m": "2"}, device="cpu")
    assert (asyncio.run(cpu.encode_async(set(range(6)), data))
            == cpu.encode(set(range(6)), data))


def _osdmap(alg=STRAW2) -> OSDMap:
    crush = CrushMap()
    hosts = [crush.add_bucket(alg, 1, [2 * h, 2 * h + 1], [0x10000] * 2,
                              id=-(h + 2)).id for h in range(3)]
    crush.add_bucket(STRAW2, 2, hosts, [0x20000] * 3, id=-1)
    crush.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 0, 1),
                    (EMIT, 0, 0)], id=0)
    m = OSDMap()
    inc = Incremental(epoch=1)
    inc.new_max_osd = 6
    inc.new_crush = crush
    inc.new_pools[1] = PGPool(id=1, name="rbd", pg_num=16, size=2,
                              crush_rule=0)
    m.apply_incremental(inc)
    inc = m.new_incremental()
    for o in range(6):
        inc.new_state[o] = OSD_EXISTS | OSD_UP
        inc.new_weight[o] = 0x10000
    m.apply_incremental(inc)
    return m


def test_background_plane_entry_points_raise_without_a_card(monkeypatch):
    """No card and no device="cpu": crc32_batch, match_batch,
    compress_async, boundary_batch and fingerprint_batch raise; the CPU
    runs when asked."""
    from ceph_tpu_torch.compress.tlz import compress_async
    from ceph_tpu_torch.dedup import boundary_batch, fingerprint_batch
    from ceph_tpu_torch.device.digest import crc32_batch
    from ceph_tpu_torch.device.lzkernel import match_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = bytes(range(256)) * 40
    for call in (crc32_batch([data]), match_batch([data[:4096]]),
                 compress_async(data), boundary_batch([data]),
                 fingerprint_batch([data])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            asyncio.run(call)
    assert asyncio.run(crc32_batch([data], device="cpu"))[1] == "device"
    assert asyncio.run(compress_async(data, device="cpu"))[1] == "device"


def test_crush_entry_points_raise_without_a_card(monkeypatch):
    """No card and no device="cpu": the bulk mapper, the OSDMap's
    device_mapper() and OSDMapMapping raise; the CPU runs when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _osdmap()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceMapper(m.crush)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.device_mapper()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OSDMapMapping(m)
    assert m.device_mapper("cpu").device == torch.device("cpu")
    mapping = OSDMapMapping(m, device="cpu")
    assert (mapping.device_pools, mapping.scalar_pools) == (1, 0)


def test_balancer_entry_points_raise_without_a_card(monkeypatch, tmp_path,
                                                  capsys):
    """No card and no device="cpu": BalancerState, calc_pg_upmaps,
    batched_calc_pg_upmaps and osdmaptool --upmap / --test-map-pgs
    --bulk raise; the CPU runs when asked."""
    from ceph_tpu_torch.cli import osdmaptool
    from ceph_tpu_torch.osd.balancer import BalancerState, calc_pg_upmaps
    from ceph_tpu_torch.scale import batched_calc_pg_upmaps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _osdmap()
    for call in (lambda: BalancerState(m, None),
                 lambda: calc_pg_upmaps(m, m.new_incremental()),
                 lambda: batched_calc_pg_upmaps(m, m.new_incremental())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    path = str(tmp_path / "m.bin")
    assert osdmaptool.main(["--createsimple", "6", "--pg-num", "16",
                            path]) == 0
    for argv in ([path, "--test-map-pgs", "--bulk"],
                 [path, "--upmap", str(tmp_path / "o.bin")]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            osdmaptool.main(argv)
    assert osdmaptool.main([path, "--test-map-pgs", "--bulk",
                            "--device", "cpu"]) == 0
    capsys.readouterr()
    assert BalancerState(m, None, device="cpu").pg_up


def test_osdmapmapping_lets_out_of_scope_maps_fail():
    """A map outside the device scope fails the build with ValueError:
    no pool degrades to the scalar host pipeline."""
    m = _osdmap(alg=UNIFORM)
    with pytest.raises(OutOfDeviceScope, match="straw2"):
        OSDMapMapping(m, device="cpu")
    m = _osdmap()
    m.crush.add_rule([(TAKE, -1, 0), (CHOOSELEAF_FIRSTN, 1, 1),
                      (CHOOSELEAF_FIRSTN, 1, 1), (EMIT, 0, 0)], id=1)
    m.pools[1].crush_rule = 1
    with pytest.raises(OutOfDeviceScope, match="single choose"):
        OSDMapMapping(m, device="cpu")
