"""Record-file input: TFRecord-framed shards (crc32c) with a native C++
reader core and a pure-Python fallback, the array example codec, and the
per-host shuffled batch dataset. Files are byte-identical to the JAX
package's in both directions."""
