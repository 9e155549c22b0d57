"""On-disk formats of the port: its own copies of what it uses from
longreadmapper_tpu/formats, with the same names and byte-identical files, so
the two packages share the five index artifacts (.mta, .cat, .sa5, .mfi,
.lch) and the reads and SAM formats."""
