"""siddhi_tpu_torch.query_api — the query object model (typed IR).

Counterpart of the reference's siddhi-query-api module: a fluent Python API for
building Siddhi apps programmatically, and the target representation of the
SiddhiQL text compiler (siddhi_tpu_torch.compiler).
"""
from .annotation import Annotation, Element, find_all, find_annotation
from .definition import (AbstractDefinition, AggregationDefinition, Attribute,
                         AttrType, FunctionDefinition, StreamDefinition,
                         TableDefinition, TriggerDefinition, WindowDefinition)
from .expression import (And, AttributeFunction, Compare, CompareOp, Constant,
                         Expression, In, IsNull, MathExpr, MathOp, Not, Or,
                         TimeConstant, Variable, variables_of, walk)
from .query import (AbsentStreamStateElement, CountStateElement, DeleteStream,
                    EventTrigger, EveryStateElement, Filter, InputStore,
                    InputStream, InsertIntoStream, JoinInputStream, JoinType,
                    LogicalOp, LogicalStateElement, NextStateElement,
                    OrderByAttribute, OutputAttribute, OutputEventsFor,
                    OutputRate, OutputRateType, OutputStream, Partition,
                    PartitionType, Query, RangePartitionProperty,
                    RangePartitionType, ReturnStream, Selector,
                    SingleInputStream, StateElement, StateInputStream,
                    StateType, StoreQuery, StoreQueryType, StreamFunctionHandler,
                    StreamHandler, StreamStateElement, UpdateOrInsertStream,
                    UpdateSetAssignment, UpdateStream, ValuePartitionType,
                    WindowHandler)
from .position import SourcePos, nearest_pos, pos_of, set_pos
from .siddhi_app import SiddhiApp
