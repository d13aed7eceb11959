"""The plain reference of the hybrid search: exact BM25 from the raw CSR
arrays, exact dense top-c over the stored rows, the int8 quantiser, the
z-score blend and their masked forms. Plain PyTorch and NumPy; it imports
nothing of the program under test and takes none of its derived data."""
