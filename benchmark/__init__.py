"""The benchmark of cvr_tpu_torch on one NVIDIA H100.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that defines the yardstick lives here and nowhere
in the program: the matrix generators, the plain NumPy reference and the
comparison that decides ``correct``, the work counts and the table of
peaks, the trace arithmetic, and one reader per metric.  A configuration
(``configs/<name>.json``), a traffic mix (``traffic/<name>.json``) and a
metric's reader (``metrics/<name>.py``) are found by the names that
``BENCHMARK.json`` gives them, and the generator of a configuration's
matrix (``generators/<name>.py``) by the name its file gives.
"""
