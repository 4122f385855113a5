"""Mean CPU ms of the mapping worker in one `mapper.keyframe` span that
lies wholly inside the window (System.mapper.process_keyframe: point
maintenance, fusion, local BA, keyframe culling).  mapper.ms_per_keyframe less this is the time the
worker waited: for the GIL, the store's lock or the device."""

from benchmark import program_spans


def read(obs):
    return program_spans.mean_cpu_ms(program_spans.whole(obs), "mapper.keyframe")
