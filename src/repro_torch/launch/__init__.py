"""Launchers: the training entry point (``launch/train.py``).  The JAX
package's production meshes, sharding resolution and dry-run wait for
later slices (ROADMAP.md §6)."""
