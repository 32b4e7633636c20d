"""Host-side cost model of the port (the GAS substrate is not ported yet)."""
