"""The port's resident loop against the reference's own ``DeviceProgram``
(``repro.core.device_vm``, a jitted ``lax.while_loop``): the same tick
schedule, so DRAM and every stat are equal, ``ticks`` and ``link_tokens``
included."""
import numpy as np
import pytest

from repro.apps import ALL_APPS as REF_APPS
from repro.core.compiler import compile_program as ref_compile
from repro.core.device_vm import DeviceProgram as RefDeviceProgram
from repro_torch.apps import ALL_APPS
from repro_torch.core.compiler import compile_program
from repro_torch.core.device_vm import DeviceProgram


@pytest.mark.parametrize("name", ["murmur3", "hash_table", "kdtree"])
def test_resident_matches_reference_device_program(name):
    app = REF_APPS[name]()
    want = RefDeviceProgram(ref_compile(app.prog).dfg).run(
        app.dram_init, **app.params)
    got = DeviceProgram(compile_program(ALL_APPS[name]().prog).dfg,
                        device="cpu").run(app.dram_init, **app.params)
    assert set(got.dram) == set(want.dram)
    for arr in want.dram:
        np.testing.assert_array_equal(got.dram[arr], want.dram[arr],
                                      err_msg=f"{name}: '{arr}'")
    assert dict(got.stats) == dict(want.stats)
    assert got.stats["ticks"] == want.stats["ticks"] > 0
