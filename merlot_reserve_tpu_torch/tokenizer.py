"""Special-token ids of the 32768-token lowercase BPE the checkpoints were
trained with. The embedding rows for these ids are baked into the released
checkpoints, so the ids are part of the compatibility surface. The BPE
itself (vocab file, encoding) is not part of the port yet."""

PADDING = 0
START = 1
END = 2
MASK = 3
MASKAUDIO = 4
AUDIOSPAN = 5
LTOVPOOL = 6
RESETCTX = 9
