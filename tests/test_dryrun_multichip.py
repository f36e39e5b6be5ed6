"""The multi-device dry run (__graft_entry__.dryrun_multichip) on a
virtual CPU mesh: sharded dense scan and chain probes bit-equal to one
device, ConClave, the NW scorer under shard_map and the pileup psum, on
a seeded panel at the gene-panel widths."""

import dataclasses

import pytest

jax = pytest.importorskip("jax")

import __graft_entry__  # noqa: E402
from kma_tpu.utils import simdata  # noqa: E402


@pytest.mark.parametrize("n_devices,mesh", [(4, [2, 2]), (2, [1, 2])])
def test_dryrun_multichip_cpu_mesh(n_devices, mesh):
    assert len(jax.devices()) >= n_devices
    sizes = dataclasses.replace(simdata.Sizes(), families=40, templates=200)
    rep = __graft_entry__.dryrun_multichip(n_devices, batch_per_shard=64,
                                           sizes=sizes)
    assert rep["mesh"] == mesh and rep["templates"] == 200
    assert rep["batch"] == 64 * mesh[0]
    assert rep["single_device_scan"] == "plain"
    assert rep["pileup_frags"] > 0 and rep["mapped_reads"] > 0
    assert rep["nw_windows"] == 512 * mesh[0]
