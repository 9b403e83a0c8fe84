"""The benchmark's general machinery: loading a cell by name, the
measured window, the device timeline, kernel work counts and chains."""
