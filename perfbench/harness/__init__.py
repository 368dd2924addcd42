"""The general part of the benchmark: what no cell, configuration or
metric owns.  ``catalog`` finds those by name, ``window`` times a cell,
``trace`` reduces a profiler trace, ``main`` runs one cell and prints
its result."""
