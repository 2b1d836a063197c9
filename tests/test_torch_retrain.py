"""The reference's retrain-loop suite (``tests/test_retrain.py``) runs
against the port's ``resilience/retrain.py`` over its serving plane, fault
plan and telemetry (``torch_fixtures/reference_suites.py``: the suite's own
code with its imports pointed at the port, on the CPU)."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import reference_suites as RS  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

RETRAIN = RS.translate("test_retrain")
globals().update(RS.fixtures(RETRAIN))


@pytest.fixture(autouse=True)
def _cpu_default():
    with RS.cpu_default():
        yield


@pytest.fixture
def fault_plan():
    from transmogrifai_tpu_torch.resilience import faults

    plan = faults.FaultPlan()
    with faults.installed(plan):
        yield plan


#: needs the distributed plane's ``resilience`` ledger source (A13)
LEAVE_OUT = {
    "TestLedgerExposure::test_stream_chunk_retry_counters_in_resilience_source",
}


@pytest.mark.parametrize("case", RS.cases(RETRAIN, LEAVE_OUT))
def test_reference_retrain_case_on_the_port(case, request):
    RS.run(RETRAIN, case, request)
