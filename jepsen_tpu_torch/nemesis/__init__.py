"""The nemesis: what the port has of it is the fault registry's
read-only surface (:mod:`jepsen_tpu_torch.nemesis.faults`), which the
reports and the forensics read."""
