"""Several devices in one process: the ('seg', 'ntt') device mesh
(`mesh.make_mesh`) and the four-step NTT and coset LDE sharded over a
mesh axis (`ntt.ntt_sharded`, `ntt.make_coset_lde_sharded`), which
`stark.machine.prove_machine(devices=, mesh=)` uses."""
