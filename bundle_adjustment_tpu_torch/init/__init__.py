"""init subpackage: DLT and EO-frame transformation."""
