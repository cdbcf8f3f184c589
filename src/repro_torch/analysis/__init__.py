"""Analysis tools of the port: so far the runtime concurrency sanitizer
(`concurrency`) that the serving layer's locks come from. The JAX
package's linters and kernel contracts are not ported yet (ROADMAP.md
queue 1 item 10)."""
