"""Every test under tests/ runs each of its phases under a time limit
(``time_limit.py``): a test that hangs fails with ``TimeLimitExceeded`` and
the session goes on, instead of a hang holding the whole run."""

from time_limit import hooks

# A backstop: about 6x the longest phase measured, the module fixture of
# test_torch_tp_zoo.py that spawns mixtral's gloo ranks (101.9 s on 8 CPU
# cores with the other heavy files running beside it).
DEFAULT_S = 600.0

# Tests of the JAX package that livelock, given about 7x the 8-9 s their
# passing siblings in the same classes take.  They stay as they are, and
# fail by their limit in every run where they hang.
OWN_S = {
    # ROADMAP.md Queue 3, closed entry 3: the reference's Pager.lease_run
    # retries forever a run longer than any stripe holds (4x oversubscribed).
    "tests/test_train_ooc.py::TestDifferential::test_bitwise_equivalence[4096-4]": 60.0,
    "tests/test_train_ooc.py::TestDifferential::test_bitwise_equivalence[8192-4]": 60.0,
    "tests/test_train_ooc.py::TestSequentialWitness::"
    "test_classifier_earns_sequential_on_moment_sweep": 60.0,
    # ROADMAP.md Queue 3, closed entry 4: the reference waits forever on a
    # stripe whose slots all hold quarantined pages (hangs in some runs).
    "tests/test_train_ooc.py::TestChaosTraining::"
    "test_outage_surfaces_oserror_then_resumes": 60.0,
}

pytest_runtest_setup, pytest_runtest_call, pytest_runtest_teardown = hooks(DEFAULT_S, OWN_S)
