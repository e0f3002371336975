"""Table III application suite — none expressible in MapReduce (§VI-A(c))."""
from . import hash_table, huffman, ip, kdtree, murmur3, search, strlen
from .common import App

# name -> zero-arg factory building a small validation instance.
# Benchmarks call the builders with larger sizes.
ALL_APPS = {
    "isipv4": ip.build_isipv4,
    "ip2int": ip.build_ip2int,
    "murmur3": murmur3.build,
    "hash_table": hash_table.build,
    "search": search.build,
    "huff_dec": huffman.build_dec,
    "huff_enc": huffman.build_enc,
    "kdtree": kdtree.build,
    "strlen": strlen.build,
}

__all__ = ["ALL_APPS", "App"]
