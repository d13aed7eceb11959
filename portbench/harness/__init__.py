"""The general parts of the benchmark: the data and traffic generators, the
drivers of the program's entry points, spans, the trace reader and the
comparison that decides ``correct``."""
