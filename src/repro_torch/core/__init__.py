"""Front end, compiler and executors (copies of the reference's
framework-neutral modules) plus the torch executor backend."""
