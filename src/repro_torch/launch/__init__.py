"""Launchers: the serve loop (``serve.BatchedLMServer``).  The
production mesh, the multi-pod dry-runs and the train loop have no
counterpart yet (ROADMAP.md §1, queue items 5 and 6)."""
