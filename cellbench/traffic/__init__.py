"""Traffic: one general generator (``generate.py``) reads a mix's data
file, ``traffic/<mix>.json``; its arrival process is a kind of its own,
``traffic/kinds/<kind>.py``, found by the name the file gives."""
