"""Model stack of the port: attention, linear scan, layers, Model."""
