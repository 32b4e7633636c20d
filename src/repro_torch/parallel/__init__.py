"""Run context of the port (one device, no mesh)."""
