"""Tools of the port: its benchmark and kernel timing harnesses."""
