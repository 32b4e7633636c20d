"""Model code of the port: layers, the layer-program stack, the facade."""
