"""The pipelined matmul: the K-loop plan (:mod:`.schedule`), the Hopper
kernel and its wrapper (:mod:`.ops`), and the plain version (:mod:`.ref`)."""
