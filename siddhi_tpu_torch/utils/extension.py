"""Extension registry — the plugin SPI.

(reference: util/SiddhiExtensionLoader.java classpath scanning of @Extension
annotation index + util/extension/holder/*ExtensionHolder typed lookups +
siddhi-annotations module.)

Python-native shape: extensions register programmatically
(`SiddhiManager.set_extension("ns:name", impl)`) or via
`importlib.metadata` entry points in the ``siddhi_tpu_torch.extensions`` group.
Supported kinds: scalar functions, attribute aggregators, windows, stream
processors, sources, sinks, mappers, stores.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclass
class ExtensionMeta:
    """Metadata attached by the @extension decorator (≙ the reference's
    @Extension annotation + @Parameter/@ReturnAttribute/@Example nested
    annotations, siddhi-annotations/.../Extension.java).  Feeds arity
    validation at compile time and tools/docgen.py rendering."""
    namespace: str
    name: str
    description: str = ""
    # (name, type, description); a name ending in '...' marks variadic
    parameters: List[Tuple[str, str, str]] = field(default_factory=list)
    returns: Optional[str] = None
    examples: List[str] = field(default_factory=list)

    @property
    def key(self) -> str:
        ns = (self.namespace or "").lower()
        return f"{ns}:{self.name.lower()}" if ns else self.name.lower()

    @property
    def variadic(self) -> bool:
        return bool(self.parameters) and \
            self.parameters[-1][0].endswith("...")


#: global index of decorated extensions — docgen renders it, and
#: SiddhiManager.set_extension validates registration names against it
EXTENSION_METADATA: Dict[str, ExtensionMeta] = {}


def extension(namespace: str = "", name: Optional[str] = None,
              description: str = "",
              parameters: Sequence[Tuple[str, str, str]] = (),
              returns: Optional[str] = None,
              examples: Sequence[str] = ()):
    """Class decorator declaring extension metadata
    (reference @Extension, util/SiddhiExtensionLoader.java:50-101 consumes
    the annotation index this mirrors)."""
    def deco(cls):
        meta = ExtensionMeta(namespace=namespace,
                             name=name or cls.__name__.lower(),
                             description=description or
                             (cls.__doc__ or "").split("\n")[0],
                             parameters=list(parameters), returns=returns,
                             examples=list(examples))
        cls.__extension_meta__ = meta
        EXTENSION_METADATA[meta.key] = meta
        return cls
    return deco


class FunctionExtension:
    """Scalar function extension.  Subclass and implement apply(*cols) →
    column; declare return_type (AttrType)."""

    return_type = None

    def apply(self, *args):
        raise NotImplementedError

    @classmethod
    def compile_call(cls, compiled_args, compiler):
        from ..plan.expr_compiler import CompiledExpr
        from .errors import SiddhiAppCreationError
        meta: Optional[ExtensionMeta] = getattr(cls, "__extension_meta__",
                                                None)
        if meta is not None and meta.parameters:
            want = len(meta.parameters)
            n = len(compiled_args)
            if meta.variadic:
                if n < want - 1:
                    raise SiddhiAppCreationError(
                        f"{meta.key}() needs at least {want - 1} "
                        f"arguments, got {n}")
            elif n != want:
                raise SiddhiAppCreationError(
                    f"{meta.key}() takes {want} arguments "
                    f"({', '.join(p[0] for p in meta.parameters)}), "
                    f"got {n}")
        inst = cls()

        def fn(ctx):
            return inst.apply(*[a.fn(ctx) for a in compiled_args])
        return CompiledExpr(fn, cls.return_type or compiled_args[0].type
                            if compiled_args else cls.return_type)


#: lazily-imported built-in extensions shipped with the framework
#: (≙ the reference's bundled extension jars resolved by SiddhiClassLoader)
_BUILTIN_EXTENSIONS: Dict[str, str] = {
    "store:sqlite": "siddhi_tpu_torch.stores.sqlite:SQLiteStore",
}


class ExtensionRegistry:
    def __init__(self):
        self._by_name: Dict[str, Any] = {}
        self._loaded_entry_points = False

    @staticmethod
    def _key(ns: str, name: str) -> str:
        ns = (ns or "").lower()
        return f"{ns}:{name.lower()}" if ns else name.lower()

    def register(self, name: str, impl):
        """name is 'ns:name' or plain 'name'."""
        self._by_name[name.lower()] = impl

    def _load_entry_points(self):
        if self._loaded_entry_points:
            return
        self._loaded_entry_points = True
        try:
            from importlib.metadata import entry_points
            for ep in entry_points(group="siddhi_tpu_torch.extensions"):
                try:
                    self._by_name.setdefault(ep.name.lower(), ep.load())
                except Exception:  # noqa: BLE001 — bad plugin must not kill app
                    import logging
                    logging.getLogger(__name__).exception(
                        "failed loading extension %s", ep.name)
        except Exception:  # noqa: BLE001
            pass

    def _find(self, ns: str, name: str, kind) -> Optional[Any]:
        self._load_entry_points()
        key = self._key(ns, name)
        impl = self._by_name.get(key)
        if impl is None and key in _BUILTIN_EXTENSIONS:
            mod, _, attr = _BUILTIN_EXTENSIONS[key].partition(":")
            import importlib
            impl = getattr(importlib.import_module(mod), attr)
            self._by_name[key] = impl
        if impl is None:
            return None
        if kind is not None and isinstance(impl, type) and \
                not issubclass(impl, kind):
            return None
        return impl

    def find_function(self, ns: str, name: str):
        return self._find(ns, name, None)

    def find_stream_processor(self, ns: str, name: str):
        return self._find(ns, name, None)

    def find_window(self, ns: str, name: str):
        return self._find(ns, name, None)

    def find_source(self, type_name: str):
        return self._find("source", type_name, None)

    def find_sink(self, type_name: str):
        return self._find("sink", type_name, None)

    def find_source_mapper(self, type_name: str):
        return self._find("sourcemapper", type_name, None)

    def find_sink_mapper(self, type_name: str):
        return self._find("sinkmapper", type_name, None)

    def find_store(self, type_name: str):
        return self._find("store", type_name, None)
