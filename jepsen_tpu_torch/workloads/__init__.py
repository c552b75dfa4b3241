"""Reusable workload kits: a generator and a checker each (the port of
jepsen_tpu/workloads/). The port has the linearizable register."""
