"""Multi-host entry point: single-process behavior must be a safe no-op."""

import jax

from bodge_tpu.parallel import initialize_multihost, is_multihost, local_device_count

_ENV_KEYS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")


def test_initialize_is_noop_single_host(monkeypatch):
    for k in _ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert initialize_multihost() is False  # no env, no args → no-op
    assert is_multihost() is False
    assert local_device_count() == len(jax.local_devices())


def test_env_detection(monkeypatch):
    from bodge_tpu.parallel import multihost

    for k in _ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert multihost._env_looks_multihost() is False
    # A coordinator address, under either name, reads as multi-host.
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    assert multihost._env_looks_multihost() is True
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1234")
    assert multihost._env_looks_multihost() is True
