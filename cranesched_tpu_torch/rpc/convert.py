"""proto <-> domain conversions for the ctld service."""

from __future__ import annotations

from cranesched_tpu_torch.ctld.defs import (
    ArraySpec,
    Dependency,
    DepType,
    Job,
    JobSpec,
    ResourceSpec,
    Step,
    StepSpec,
)
from cranesched_tpu_torch.rpc import crane_pb2 as pb

_DEP_TYPES = {t.value: t for t in DepType}


def res_from_pb(msg) -> ResourceSpec:
    gres = None
    if msg.gres:
        gres = {}
        for key, count in msg.gres.items():
            name, _, typ = key.partition(":")
            gres[(name, typ)] = count
    return ResourceSpec(cpu=msg.cpu or 0.0, mem_bytes=msg.mem_bytes,
                        memsw_bytes=msg.memsw_bytes, gres=gres)


def res_to_pb(res: ResourceSpec) -> pb.ResourceSpec:
    msg = pb.ResourceSpec(cpu=res.cpu, mem_bytes=res.mem_bytes,
                          memsw_bytes=res.memsw_bytes)
    for (name, typ), count in (res.gres or {}).items():
        msg.gres[f"{name}:{typ}"] = count
    return msg


def spec_from_pb(msg) -> JobSpec:
    deps = []
    for d in msg.dependencies:
        dep_type = _DEP_TYPES.get(d.type)
        if dep_type is None:
            raise ValueError(
                f"unknown dependency type {d.type!r} "
                f"(expected one of {sorted(_DEP_TYPES)})")
        deps.append(Dependency(job_id=d.job_id, type=dep_type,
                               delay_seconds=d.delay_seconds))
    deps = tuple(deps)
    array = None
    if msg.HasField("array"):
        array = ArraySpec(start=msg.array.start, end=msg.array.end,
                          stride=msg.array.stride or 1,
                          max_concurrent=msg.array.max_concurrent)
    return JobSpec(
        name=msg.name or "job",
        user=msg.user or "user",
        account=msg.account or "default",
        partition=msg.partition or "default",
        res=res_from_pb(msg.res),
        node_num=msg.node_num or 1,
        task_res=(res_from_pb(msg.task_res)
                  if msg.HasField("task_res") else None),
        ntasks=msg.ntasks or None,
        ntasks_per_node_min=msg.ntasks_per_node_min or 1,
        ntasks_per_node_max=msg.ntasks_per_node_max or 1,
        exclusive=msg.exclusive,
        time_limit=msg.time_limit or 3600,
        qos=msg.qos,
        qos_priority=msg.qos_priority,
        held=msg.held,
        include_nodes=tuple(msg.include_nodes),
        exclude_nodes=tuple(msg.exclude_nodes),
        begin_time=msg.begin_time or None,
        requeue_if_failed=msg.requeue_if_failed,
        dependencies=deps,
        deps_is_or=msg.deps_is_or,
        array=array,
        reservation=msg.reservation,
        script=msg.script,
        output_path=msg.output_path,
        alloc_only=msg.alloc_only,
        interactive_address=msg.interactive_address,
        pty=msg.pty,
        interactive_token=msg.interactive_token,
        container_image=msg.container_image,
        container_mounts=tuple(msg.container_mounts),
        x11=msg.x11,
        x11_cookie=msg.x11_cookie,
        sim_runtime=msg.sim_runtime or None,
        sim_exit_code=msg.sim_exit_code,
    )


def spec_to_pb(spec: JobSpec) -> pb.JobSpec:
    msg = pb.JobSpec(
        name=spec.name, user=spec.user, account=spec.account,
        partition=spec.partition, res=res_to_pb(spec.res),
        node_num=spec.node_num,
        ntasks=spec.ntasks or 0,
        ntasks_per_node_min=spec.ntasks_per_node_min,
        ntasks_per_node_max=spec.ntasks_per_node_max,
        # host-side limits are float seconds; the wire field is uint32
        # (a float here raises TypeError inside a dispatch thread)
        exclusive=spec.exclusive, time_limit=int(spec.time_limit),
        qos=spec.qos, qos_priority=spec.qos_priority, held=spec.held,
        include_nodes=list(spec.include_nodes),
        exclude_nodes=list(spec.exclude_nodes),
        begin_time=spec.begin_time or 0.0,
        requeue_if_failed=spec.requeue_if_failed,
        deps_is_or=spec.deps_is_or,
        reservation=spec.reservation,
        script=spec.script, output_path=spec.output_path,
        alloc_only=spec.alloc_only,
        interactive_address=spec.interactive_address,
        pty=spec.pty,
        interactive_token=spec.interactive_token,
        container_image=spec.container_image,
        container_mounts=list(spec.container_mounts),
        x11=spec.x11,
        x11_cookie=spec.x11_cookie,
        sim_runtime=spec.sim_runtime or 0.0,
        sim_exit_code=spec.sim_exit_code)
    if spec.task_res is not None:
        msg.task_res.CopyFrom(res_to_pb(spec.task_res))
    for dep in spec.dependencies:
        msg.dependencies.add(job_id=dep.job_id, type=dep.type.value,
                             delay_seconds=dep.delay_seconds)
    if spec.array is not None:
        msg.array.CopyFrom(pb.ArraySpec(
            start=spec.array.start, end=spec.array.end,
            stride=spec.array.stride,
            max_concurrent=spec.array.max_concurrent))
    return msg


def step_spec_from_pb(msg) -> StepSpec:
    return StepSpec(
        name=msg.name or "step",
        script=msg.script,
        res=res_from_pb(msg.res) if msg.HasField("res") else None,
        node_num=msg.node_num,
        time_limit=msg.time_limit,
        output_path=msg.output_path,
        interactive_address=msg.interactive_address,
        pty=msg.pty,
        interactive_token=msg.interactive_token,
        container_image=msg.container_image,
        container_mounts=tuple(msg.container_mounts),
        overlap=msg.overlap,
        follow_step=(msg.follow_step
                     if msg.HasField("follow_step") else None),
        x11=msg.x11,
        x11_cookie=msg.x11_cookie,
        sim_runtime=msg.sim_runtime or None,
        sim_exit_code=msg.sim_exit_code,
    )


def step_spec_to_pb(spec: StepSpec) -> pb.StepSpec:
    msg = pb.StepSpec(name=spec.name, script=spec.script,
                      node_num=spec.node_num,
                      time_limit=int(spec.time_limit),
                      output_path=spec.output_path,
                      interactive_address=spec.interactive_address,
                      pty=spec.pty,
                      interactive_token=spec.interactive_token,
                      container_image=spec.container_image,
                      container_mounts=list(spec.container_mounts),
                      overlap=spec.overlap,
                      x11=spec.x11,
                      x11_cookie=spec.x11_cookie,
                      sim_runtime=spec.sim_runtime or 0.0,
                      sim_exit_code=spec.sim_exit_code)
    if spec.follow_step is not None:
        msg.follow_step = spec.follow_step
    if spec.res is not None:
        msg.res.CopyFrom(res_to_pb(spec.res))
    return msg


def _node_name(node_names, n: int) -> str:
    """Archived history can reference nodes that left the topology (or
    a rebuilt cluster whose ids shifted) — render a placeholder, never
    crash the query surface."""
    return node_names.get(n, f"node#{n}")


def step_to_pb(job_id: int, step: Step, node_names) -> pb.StepInfo:
    return pb.StepInfo(
        job_id=job_id,
        step_id=step.step_id,
        name=step.spec.name,
        status=step.status.value,
        exit_code=step.exit_code or 0,
        submit_time=step.submit_time,
        start_time=step.start_time or 0.0,
        end_time=step.end_time or 0.0,
        node_names=[_node_name(node_names, n) for n in step.node_ids],
        cpu_seconds=step.cpu_seconds,
        max_rss_bytes=step.max_rss_bytes,
    )


def job_to_pb(job: Job, node_names) -> pb.JobInfo:
    return pb.JobInfo(
        job_id=job.job_id,
        name=job.spec.name,
        user=job.spec.user,
        account=job.spec.account,
        partition=job.spec.partition,
        status=job.status.value,
        pending_reason=job.pending_reason.value,
        node_names=[_node_name(node_names, n) for n in job.node_ids],
        task_layout=job.task_layout,
        submit_time=job.submit_time,
        start_time=job.start_time or 0.0,
        end_time=job.end_time or 0.0,
        exit_code=job.exit_code or 0,
        requeue_count=job.requeue_count,
        qos=job.qos_name,
        priority=job.priority,
        array_parent_id=job.array_parent_id or 0,
        array_task_id=(job.array_task_id
                       if job.array_task_id is not None else -1),
        cpu_seconds=job.cpu_seconds,
        max_rss_bytes=job.max_rss_bytes,
    )
