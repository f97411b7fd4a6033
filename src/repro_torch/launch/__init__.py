"""Launchers: the train loop (``train.main``), the serve loop
(``serve.BatchedLMServer``) and the data mesh with its rank launcher
(``mesh.make_data_mesh``, ``mesh.spawn_ranks``).  The production meshes
and the multi-pod dry-runs have no counterpart yet (ROADMAP.md §1, queue
item 6)."""
