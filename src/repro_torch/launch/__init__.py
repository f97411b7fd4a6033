"""Launchers: the train loop (``train.main``, over a mesh of ranks with
``--mesh``), the serve loop (``serve.BatchedLMServer``), the meshes and
the rank launcher (``mesh``), the per-cell builders (``specs``) and the
dry runs of the LM cells (``dryrun``) and of the streaming job
(``dryrun_streaming``) on a fake world of 256 or 512 ranks."""
