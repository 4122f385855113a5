"""Mean CPU ms of one `planes.keyframe` span that lies wholly inside the
window (System.plane_mapper.process_keyframe: the keyframe's segmentation
on the device and its copy back, association, merge)."""

from benchmark import program_spans


def read(obs):
    return program_spans.mean_cpu_ms(program_spans.whole(obs), "planes.keyframe")
