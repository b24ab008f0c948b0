"""The driver entry points: the jittable forward step and the multi-device
dry run on the 8 virtual CPU devices of the test session."""

import numpy as np
import pytest

import jax

import __graft_entry__ as graft
from bodge_tpu.ops import chebyshev as kpm


def test_entry_forward_matches_moments():
    fn, (data, v0, inv) = graft.entry()
    mu = np.asarray(jax.jit(fn)(data, v0, inv))
    assert mu.shape == (32, 4)
    _, system = graft._build_swave((32, 32, 1))
    want = np.asarray(kpm.moments(system.data, system.skeleton, np.asarray(v0), 32, 1 / float(inv)))
    np.testing.assert_allclose(mu, want, atol=1e-10)


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_dryrun_multichip(n_devices, capsys):
    graft.dryrun_multichip(n_devices)
    assert "sharded spmm and moments match one device" in capsys.readouterr().out


def test_dryrun_multichip_refuses_missing_devices():
    """Too few devices is an error with the fix in it, never a platform swap."""
    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match="xla_force_host_platform_device_count"):
        graft.dryrun_multichip(n)
    assert jax.devices()[0].platform == "cpu"
