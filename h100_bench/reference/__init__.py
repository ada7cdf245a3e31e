"""The plain reference of the benchmark: serial Python copies of the
port's block decoder, Huff0 decoder and frame reader, frozen, importing
nothing outside this folder."""
