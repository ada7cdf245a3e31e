"""The bit-exact oracle of the port (the lizard_tpu/ref counterparts): serial
Python on bytes, reached only through backend="ref" or these module names.

- ``huf`` / ``huf_encode``   -- Huff0 decode and encode (headers, tables, the
                                serial 4-stream codec)
- ``block_decode``           -- the block-stream decoder (decompress)
- ``block_encode``           -- the block-stream encoder (compress,
                                compress_range, Ctx, Tables), with
                                ``parsers``, ``parser_optimal`` and ``price``
"""
