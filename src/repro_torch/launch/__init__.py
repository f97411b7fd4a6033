"""Launchers: the serve loop (``serve.BatchedLMServer``) and the data mesh
with its rank launcher (``mesh.make_data_mesh``, ``mesh.spawn_ranks``).
The production meshes, the multi-pod dry-runs and the train loop have no
counterpart yet (ROADMAP.md §1, queue items 5 and 6)."""
