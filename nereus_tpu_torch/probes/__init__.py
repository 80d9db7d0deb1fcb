"""Probes of the port's kernels: the in-kernel cell check (:mod:`.cells`,
the counterpart of ``tools/wideprobe.py``) and the source-layout probe
(:mod:`.layout`, the counterpart of ``tools/probe_transposed.py``)."""
