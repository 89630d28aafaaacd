"""Example workloads (counterpart of ``kubegpu_tpu/workloads``) —
reference: ``example/`` pod specs (SURVEY.md §3).

``programs/`` are the port's programs, launched by the (simulated) runtime
with the injected env on the cards their grants name; ``data.py`` is their
input pipeline; ``specs.py`` builds the five BASELINE.json acceptance-config
pod/gang specs that exercise the full stack.
"""
