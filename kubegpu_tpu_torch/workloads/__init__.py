"""Workloads the cluster schedules, as programs a pod runs (counterpart of
``kubegpu_tpu/workloads``; so far the Llama serving program)."""
