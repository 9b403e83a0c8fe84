"""io subpackage: readers, writers and the columnar loader."""
