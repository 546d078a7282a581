"""Launchers: the training entry point (``launch/train.py``), the
production meshes (``launch/mesh.py``) and the sharding rules and their
resolution into DTensor placements (``launch/sharding.py``).  The JAX
package's dry run waits for a later slice (ROADMAP.md §6)."""
