"""Meshes, cells, the roofline and the dry run (port of ``repro.launch``)."""
