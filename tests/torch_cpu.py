"""The fixture by which the port's tests ask for the CPU.

fenicssolver_tpu_torch runs on the card unless the caller asks for the CPU
(``FST_DEVICE=cpu`` or ``device="cpu"``).  Each ``tests/test_torch_*.py``
imports ``on_the_cpu``; being autouse and module-scoped, it sets
``FST_DEVICE=cpu`` before any of the module's fixtures and tests run and
restores the environment after them."""

import pytest


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FST_DEVICE", "cpu")
        yield
