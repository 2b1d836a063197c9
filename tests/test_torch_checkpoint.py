"""The reference's resilience suite (``tests/test_resilience.py``: layer
checkpoints and resume, the CV candidate checkpoints, the fault plan, the
retry policy, atomic persistence, the score guards, reader retries) runs
against the port (``torch_fixtures/reference_suites.py``: the suite's own
code with its imports pointed at the port, on the CPU)."""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_fixtures"))
import reference_suites as RS  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.torch_port

RESILIENCE = RS.translate("test_resilience")
globals().update(RS.fixtures(RESILIENCE))


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


#: the compile plane's program bank (A14)
LEAVE_OUT = {
    "TestCorruptAotBlob::test_truncated_blob_is_deleted_and_recompiled",
    "TestCorruptAotBlob::test_acquire_banked_guards_valid_pickle_wrong_payload",
}


@pytest.mark.parametrize("case", RS.cases(RESILIENCE, LEAVE_OUT))
def test_reference_resilience_case_on_the_port(case, request):
    RS.run(RESILIENCE, case, request)
