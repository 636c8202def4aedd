"""Plain NumPy references, one a configuration, named after it. They
import nothing of the port, of JAX or of the JAX package."""
