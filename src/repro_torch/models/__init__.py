"""Model zoo: config, layers, mixers, assembly."""
