"""Multi-process and multi-device runs: layouts and collectives (mesh.py),
collaborative serving (serve.py), and the rank launcher (launch.py)."""
